"""MSB-first bitstream reader and writer.

Capability parity with reference common/src/bitstream_reader.ml (show/advance/
get/align_to_byte, zero-fill past end of buffer) and bitstream_writer.ml
(≤16-bit puts, JPEG 0xFF→0xFF00 byte stuffing, flush_with_1s).

The reader peeks via an integer window rather than the reference's bit-by-bit
loop — same semantics, fewer Python ops (this is the model decoder's hot path;
the production hot path lives in native/entropy.cpp and ops/).
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("buffer", "length_in_bits", "bit_pos")

    def __init__(self, buffer: bytes):
        self.buffer = bytes(buffer)
        self.length_in_bits = len(self.buffer) * 8
        self.bit_pos = 0

    def get_byte(self, byte_no: int) -> int:
        """Byte at index, 0 when out of bounds (bitstream_reader.ml:19-22 —
        deliberately lets the decoder read past EOF safely)."""
        if 0 <= byte_no < len(self.buffer):
            return self.buffer[byte_no]
        return 0

    def show(self, n: int) -> int:
        """Peek the next n (≤16 in practice) bits without advancing.

        Reads that *start* inside the buffer zero-fill past the end (the
        reference decoder relies on this — bitstream_reader.ml:19-22);
        once the cursor itself is past the end, raise. The reference
        instead zero-fills forever (its width-only guard at
        bitstream_reader.ml:32), which turns truncated headers into an
        infinite marker-scan loop — raising is the strict improvement."""
        if self.bit_pos >= self.length_in_bits:
            raise ValueError("BitReader out of bounds")
        if n == 0:
            return 0
        pos = self.bit_pos
        first = pos >> 3
        # Window of up to 4 bytes covers any ≤16-bit read at any alignment.
        window = self.buffer[first:first + 4]
        v = int.from_bytes(window.ljust(4, b"\x00"), "big")
        return (v >> (32 - (pos & 7) - n)) & ((1 << n) - 1)

    def advance(self, n: int) -> None:
        self.bit_pos += n

    def get(self, n: int) -> int:
        v = self.show(n)
        self.bit_pos += n
        return v

    def bits_left(self) -> int:
        return self.length_in_bits - self.bit_pos

    def align_to_byte(self) -> None:
        rem = self.bit_pos & 7
        if rem:
            self.bit_pos += 8 - rem


class BitWriter:
    """MSB-first bit writer with optional JPEG byte stuffing.

    Mirrors common/src/bitstream_writer.ml: an integer word buffer is flushed
    a byte at a time; with ``stuffing`` a 0x00 is inserted after each emitted
    0xFF (the stuffed byte does not count toward ``bits_written`` alignment —
    bytes_written tracks all emitted bytes exactly as the reference does).
    """

    __slots__ = ("word_buffer", "word_bits", "buffer", "bytes_written")

    def __init__(self):
        self.word_buffer = 0
        self.word_bits = 0
        self.buffer = bytearray()
        self.bytes_written = 0

    def _flush(self, stuffing: bool) -> None:
        while self.word_bits >= 8:
            d = (self.word_buffer >> (self.word_bits - 8)) & 0xFF
            self.buffer.append(d)
            self.bytes_written += 1
            self.word_bits -= 8
            # Keep the retired bits masked off so word_buffer stays small.
            self.word_buffer &= (1 << self.word_bits) - 1
            if stuffing and d == 0xFF:
                self.buffer.append(0)
                self.bytes_written += 1

    def put_bits(self, value: int, bits: int, *, stuffing: bool) -> None:
        assert bits <= 16
        if bits == 0:
            return
        self.word_buffer = ((self.word_buffer << bits)
                            | (value & ((1 << bits) - 1)))
        self.word_bits += bits
        self._flush(stuffing)

    def bits_written(self) -> int:
        return self.bytes_written * 8 + self.word_bits

    def flush_with_1s(self, *, stuffing: bool) -> None:
        """Pad to a byte boundary with 1-bits (JPEG convention)."""
        while self.bits_written() & 7:
            self.put_bits(1, 1, stuffing=stuffing)

    def get_buffer(self) -> bytes:
        return bytes(self.buffer)

    def put_bytes(self, data: bytes) -> None:
        """Byte-aligned raw append (used for header segments)."""
        assert self.word_bits == 0
        self.buffer.extend(data)
        self.bytes_written += len(data)
