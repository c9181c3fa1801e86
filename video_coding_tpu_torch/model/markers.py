"""JPEG header segment record types with bit-level decode/encode.

Capability parity with reference jpeg/model/src/markers.ml: Component, Sof,
Scan_component, Sos, Dqt, Dri, Dht. Field layouts per ITU-T T.81 Annex B.
"""

from __future__ import annotations

import dataclasses

from ..common.bitstream import BitReader, BitWriter


@dataclasses.dataclass
class Component:
    """SOF per-component descriptor (markers.ml:6-35)."""

    identifier: int
    horizontal_sampling_factor: int
    vertical_sampling_factor: int
    quantization_table_identifier: int

    BYTES = 3

    @classmethod
    def decode(cls, bits: BitReader) -> "Component":
        return cls(
            identifier=bits.get(8),
            horizontal_sampling_factor=bits.get(4),
            vertical_sampling_factor=bits.get(4),
            quantization_table_identifier=bits.get(8),
        )

    def encode(self, w: BitWriter) -> None:
        w.put_bits(self.identifier, 8, stuffing=False)
        w.put_bits(self.horizontal_sampling_factor, 4, stuffing=False)
        w.put_bits(self.vertical_sampling_factor, 4, stuffing=False)
        w.put_bits(self.quantization_table_identifier, 8, stuffing=False)


@dataclasses.dataclass
class Sof:
    """Start-of-frame segment (markers.ml:38-72)."""

    length: int
    sample_precision: int
    width: int
    height: int
    number_of_components: int
    components: list[Component]

    @classmethod
    def decode(cls, bits: BitReader) -> "Sof":
        length = bits.get(16)
        sample_precision = bits.get(8)
        height = bits.get(16)
        width = bits.get(16)
        n = bits.get(8)
        components = [Component.decode(bits) for _ in range(n)]
        return cls(length, sample_precision, width, height, n, components)

    def encode(self, w: BitWriter) -> None:
        length = 2 + 6 + self.number_of_components * Component.BYTES
        w.put_bits(length, 16, stuffing=False)
        w.put_bits(self.sample_precision, 8, stuffing=False)
        w.put_bits(self.height, 16, stuffing=False)
        w.put_bits(self.width, 16, stuffing=False)
        w.put_bits(self.number_of_components, 8, stuffing=False)
        for c in self.components:
            c.encode(w)


@dataclasses.dataclass
class ScanComponent:
    """SOS per-component selectors (markers.ml:74-96)."""

    selector: int
    dc_coef_selector: int
    ac_coef_selector: int

    BYTES = 2

    @classmethod
    def decode(cls, bits: BitReader) -> "ScanComponent":
        return cls(bits.get(8), bits.get(4), bits.get(4))

    def encode(self, w: BitWriter) -> None:
        w.put_bits(self.selector, 8, stuffing=False)
        w.put_bits(self.dc_coef_selector, 4, stuffing=False)
        w.put_bits(self.ac_coef_selector, 4, stuffing=False)


@dataclasses.dataclass
class Sos:
    """Start-of-scan segment (markers.ml:99-151)."""

    length: int
    number_of_image_components: int
    scan_components: list[ScanComponent]
    start_of_predictor_selection: int
    end_of_predictor_selection: int
    successive_approximation_bit_high: int
    successive_approximation_bit_low: int

    @classmethod
    def decode(cls, bits: BitReader) -> "Sos":
        length = bits.get(16)
        n = bits.get(8)
        scan_components = [ScanComponent.decode(bits) for _ in range(n)]
        return cls(
            length, n, scan_components,
            start_of_predictor_selection=bits.get(8),
            end_of_predictor_selection=bits.get(8),
            successive_approximation_bit_high=bits.get(4),
            successive_approximation_bit_low=bits.get(4),
        )

    def encode(self, w: BitWriter) -> None:
        length = 2 + 4 + self.number_of_image_components * ScanComponent.BYTES
        w.put_bits(length, 16, stuffing=False)
        w.put_bits(self.number_of_image_components, 8, stuffing=False)
        for sc in self.scan_components:
            sc.encode(w)
        w.put_bits(self.start_of_predictor_selection, 8, stuffing=False)
        w.put_bits(self.end_of_predictor_selection, 8, stuffing=False)
        w.put_bits(self.successive_approximation_bit_high, 4, stuffing=False)
        w.put_bits(self.successive_approximation_bit_low, 4, stuffing=False)


@dataclasses.dataclass
class Dqt:
    """Quantization table segment; 64 elements in zigzag order
    (markers.ml:153-184)."""

    length: int
    element_precision: int  # 8 or 16
    table_identifier: int
    elements: list[int]

    @classmethod
    def decode(cls, bits: BitReader) -> "Dqt":
        length = bits.get(16)
        element_precision = 8 << bits.get(4)
        table_identifier = bits.get(4)
        elements = [bits.get(element_precision) for _ in range(64)]
        return cls(length, element_precision, table_identifier, elements)

    @classmethod
    def decode_segment(cls, bits: BitReader) -> list["Dqt"]:
        """Parse every table in one DQT segment — a single marker segment
        may legally carry multiple tables (T.81 B.2.4.1; ffmpeg emits
        these)."""
        start = bits.bit_pos
        length = bits.get(16)
        out = []
        while bits.bit_pos - start < length * 8:
            element_precision = 8 << bits.get(4)
            table_identifier = bits.get(4)
            elements = [bits.get(element_precision) for _ in range(64)]
            out.append(cls(length, element_precision, table_identifier,
                           elements))
        return out

    def encode(self, w: BitWriter) -> None:
        element_bytes = self.element_precision // 8
        length = 3 + 64 * element_bytes
        w.put_bits(length, 16, stuffing=False)
        w.put_bits(element_bytes - 1, 4, stuffing=False)
        w.put_bits(self.table_identifier, 4, stuffing=False)
        for e in self.elements:
            w.put_bits(int(e), self.element_precision, stuffing=False)


@dataclasses.dataclass
class Dri:
    """Restart interval segment (markers.ml:186-198). Unlike the reference
    (which parses but ignores it), this framework uses restart intervals as
    its parallel-entropy mechanism."""

    length: int
    restart_interval: int

    @classmethod
    def decode(cls, bits: BitReader) -> "Dri":
        return cls(bits.get(16), bits.get(16))

    def encode(self, w: BitWriter) -> None:
        w.put_bits(4, 16, stuffing=False)
        w.put_bits(self.restart_interval, 16, stuffing=False)


@dataclasses.dataclass
class Dht:
    """Huffman table segment (markers.ml:200-232)."""

    length: int
    table_class: int  # 0=DC, 1=AC
    destination_identifier: int
    lengths: list[int]  # 16 counts
    values: list[int]

    @classmethod
    def decode(cls, bits: BitReader) -> "Dht":
        length = bits.get(16)
        table_class = bits.get(4)
        destination_identifier = bits.get(4)
        lengths = [bits.get(8) for _ in range(16)]
        values = [bits.get(8) for _ in range(sum(lengths))]
        return cls(length, table_class, destination_identifier, lengths, values)

    @classmethod
    def decode_segment(cls, bits: BitReader) -> list["Dht"]:
        """Parse every table in one DHT segment (T.81 B.2.4.2 allows
        multiple per marker)."""
        start = bits.bit_pos
        length = bits.get(16)
        out = []
        while bits.bit_pos - start < length * 8:
            table_class = bits.get(4)
            destination_identifier = bits.get(4)
            lengths = [bits.get(8) for _ in range(16)]
            values = [bits.get(8) for _ in range(sum(lengths))]
            out.append(cls(length, table_class, destination_identifier,
                           lengths, values))
        return out

    def encode(self, w: BitWriter) -> None:
        length = 3 + 16 + sum(self.lengths)
        w.put_bits(length, 16, stuffing=False)
        w.put_bits(self.table_class, 4, stuffing=False)
        w.put_bits(self.destination_identifier, 4, stuffing=False)
        for v in self.lengths:
            w.put_bits(v, 8, stuffing=False)
        for v in self.values:
            w.put_bits(v, 8, stuffing=False)
