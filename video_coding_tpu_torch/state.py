"""Session state: the arrays a decoder or encoder session computes with.

A session derives its state from the stream header (decoder) or the
encode parameters (encoder) as numpy arrays, then holds it as tensors on
its device. ``from_numpy`` builds that tensor state from numpy arrays —
the session's own, or those of another implementation of the same codec
(the reference sessions expose the same arrays), so both compute with
identical inputs: the codec's counterpart of carrying weights across.

Decoder arrays:
  quant (n_blocks, 64) int32 zigzag quant row of every block;
  comp_idx (n_blocks,) int32 component of every block;
  plane_geom [(idx (n_c,) int32, nby, nbx)] per component: schedule rows
    of the component's blocks in raster order;
  range_tables (lo, hi, offset, values) for K1, K5, K6 and K7;
  luts (dc (C, 65536), ac (C, 65536)) int32, the tables expanded to every
    16-bit window, for the "lut" strategy's plain loop.
Encoder arrays:
  quant, comp_idx as above;
  perm (n_blocks,) int32: stream block i is block perm[i] of the
    scan-major concatenation of every scan's raster blocks;
  gather [(take, dest, nby, nbx)] per scan (perm's per-scan parts);
  tables (dc_bits (C, 12), dc_len, ac_bits (C, 16, 11), ac_len) int32;
  prev_same_comp (blocks_per_segment,) int32: for every position of a
    segment's block schedule, the previous position of the same component
    in the segment, or -1 (the split encoder's DC predictor gather).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .entropy.huffman_encode import packed_tables


def _t(a, device, dtype=torch.int32) -> torch.Tensor:
    # a copy: the arrays may be read-only views owned by their producer
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass
class DecoderState:
    quant: torch.Tensor
    comp_idx: torch.Tensor
    plane_idx: list              # [(idx int64 tensor, nby, nbx)]
    lo: torch.Tensor
    hi: torch.Tensor
    offset: torch.Tensor
    values: torch.Tensor
    luts: torch.Tensor           # (2C, 65536): DC rows, then AC rows

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "DecoderState":
        lo, hi, offset, values = arrays["range_tables"]
        return cls(
            quant=_t(arrays["quant"], device),
            comp_idx=_t(arrays["comp_idx"], device),
            plane_idx=[(_t(idx, device, torch.int64), int(nby), int(nbx))
                       for idx, nby, nbx in arrays["plane_geom"]],
            lo=_t(lo, device), hi=_t(hi, device),
            offset=_t(offset, device), values=_t(values, device),
            luts=_t(np.concatenate(arrays["luts"]), device))

    def to_numpy(self) -> dict:
        lo, hi, off, val = (x.cpu().numpy() for x in (self.lo, self.hi,
                                                       self.offset,
                                                       self.values))
        return {
            "quant": self.quant.cpu().numpy(),
            "comp_idx": self.comp_idx.cpu().numpy(),
            "plane_geom": [(idx.cpu().numpy().astype(np.int32), nby, nbx)
                           for idx, nby, nbx in self.plane_idx],
            "range_tables": (lo, hi, off, val),
            "luts": tuple(self.luts.cpu().numpy().reshape(
                2, -1, self.luts.shape[1])),
        }


@dataclasses.dataclass
class EncoderState:
    quant: torch.Tensor
    comp_idx: torch.Tensor
    perm: torch.Tensor           # int64
    gather: list                 # numpy [(take, dest, nby, nbx)] per scan
    tables: tuple                # numpy (dc_bits, dc_len, ac_bits, ac_len)
    dctab: torch.Tensor          # (C·12,) packed (code << 5 | len)
    actab: torch.Tensor          # (C·176,)
    prev_same_comp: torch.Tensor  # (blocks_per_segment,) int32

    @property
    def plane_dims(self) -> list:
        """[(nby, nbx)] block grid of every scan."""
        return [(int(nby), int(nbx)) for _t, _d, nby, nbx in self.gather]

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "EncoderState":
        dctab, actab = packed_tables(*arrays["tables"])
        return cls(
            quant=_t(arrays["quant"], device),
            comp_idx=_t(arrays["comp_idx"], device),
            perm=_t(arrays["perm"], device, torch.int64),
            gather=list(arrays["gather"]), tables=tuple(arrays["tables"]),
            dctab=_t(dctab, device), actab=_t(actab, device),
            prev_same_comp=_t(arrays["prev_same_comp"], device))

    def to_numpy(self) -> dict:
        return {
            "quant": self.quant.cpu().numpy(),
            "comp_idx": self.comp_idx.cpu().numpy(),
            "perm": self.perm.cpu().numpy().astype(np.int32),
            "gather": self.gather,
            "tables": self.tables,
            "prev_same_comp": self.prev_same_comp.cpu().numpy(),
        }


def from_numpy(decoder: dict | None = None, encoder: dict | None = None, *,
               device) -> tuple:
    """(DecoderState | None, EncoderState | None) on ``device`` from the
    decoder and/or encoder numpy arrays."""
    return (None if decoder is None
            else DecoderState.from_numpy(decoder, device),
            None if encoder is None
            else EncoderState.from_numpy(encoder, device))
