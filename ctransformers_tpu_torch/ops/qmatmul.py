"""Quantized weights as torch tensors: the QTensor container, load-time
repacking, QKV / gate-up fusion, and the matmul dispatch onto the Hopper
kernels of ops/qmm_kernels.py with the kernel of each (weight shape, m)
chosen by a race on the card (autotune) and kept in a table.

The counterpart of ctransformers_tpu/ops/qmatmul.py. A GGML block tensor is
repacked at load time into planes that compute x @ W with W logically
(in_features K, out_features N), padded to (K_pad, N_pad):

    qs     (K_pad/2, N_pad) int8   4-bit grids (Q4_K, Q2_K, Q3_K, GPTQ4,
                                   Q4_0, Q4_1), "adjk" layout: byte (r, n)
                                   holds rows 2r (low nibble) and 2r+1
                                   (high nibble), both as two's-complement
                                   q + zp - 8
           (K_pad, N_pad) int8     int8 grids (Q6_K: q in [-32, 31], Q5_K
                                   and Q5_1: [0, 31], Q5_0: [-16, 15], Q8_0:
                                   [-128, 127]), one byte per weight
    scales (K_pad/g, N_pad) int8   k-quant sub-scales per group of g rows
                                   (g = 32; 16 for Q6_K, Q2_K and Q3_K)
    mins   (K_pad/g, N_pad) int8   sub-mins (None when the format has none,
                                   as Q6_K and Q3_K)
    sd, sm (K_pad/256, N_pad) f32  superblock factors: s = sd * scales,
                                   m = sm * mins

so that W = q * s + m. The zero point zp is 8 for Q4_0 and Q3_K, whose
grids are signed ([-8, 7] and [-4, 3], stored as they are, no bias), and 0
for the other nibble grids (Q4_K's and Q4_1's [0, 15], Q2_K's [0, 3],
stored as q - 8, so W = w4 * s + 8 * s + m).

Weights without superblocks are not factored: scales and mins are the f32
(K_pad/g, N_pad) planes s and m themselves, sd and sm are absent (sfactor
0). These are GPTQ 4-bit weights (formats/gptq.py; g is the checkpoint's
group size, 128, 64 or 32, and an act-order checkpoint adds `perm`, the
(K,) gather of input rows that makes its groups contiguous) and the legacy
GGML types Q4_0, Q4_1 (nibbles), Q5_0, Q5_1 and Q8_0 (int8 grids), all at
g = 32.

4-bit grids come in two layouts, as in the JAX package, chosen when the
weight is packed (_pack4_layout):

    adjk   (K_pad/2, N_pad) int8, as above: rows 2r and 2r+1 in byte r
    ksplit (K_pad/2, N_pad) uint8: byte r holds row r in the low nibble as
           q + zp, and row r + K_pad/2 in the high nibble, sign-biased (the
           byte XOR 0x80), so that the byte read as int8 is
           16 * (hi - 8) + lo: floor(b / 16) = hi - 8, b - 16 floor(b / 16)
           = lo

CT_PACK4_LAYOUT="ksplit" or "adjk" picks one; anything else gives adjk.
The JAX package falls back to ksplit where its TPU backend cannot bitcast
int4 (its _int4_ok capability probe, so a CPU host packs ksplit); on
Hopper unpacking a nibble is two integer instructions in either layout, so
that probe has no counterpart here and adjk is the port's default. The
planes equal the JAX package's byte for byte in both layouts.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..formats.quants import GGMLType, decompose, decompose_factors
from ..logger import logger
from . import qmm_kernels as kern

# formats stored nibble-packed, with the zero point that re-biases their
# grid into [0, 15] (Q4_0's and Q3_K's are signed)
_PACK4_ZP = {"Q4_0": 8, "Q3_K": 8, "Q4_1": 0, "Q2_K": 0, "Q4_K": 0, "GPTQ4": 0}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class QTensor:
    """A quantized 2-D weight (see the module docstring). One layer's
    weight is one QTensor: the port walks layers in Python, so it needs
    neither the JAX package's layer stacking nor its tensor-parallel tag."""

    qs: torch.Tensor
    scales: torch.Tensor
    mins: Optional[torch.Tensor]
    kind: str  # ggml type name, e.g. "Q4_K"
    group: int
    shape: Tuple[int, int]  # logical (K, N)
    packed: bool = False
    zp: int = 0
    perm: Optional[torch.Tensor] = None  # (K,) input-row gather (GPTQ)
    # fused weight (QKV / gate-up): per-segment (padded, logical) widths
    splits: Optional[tuple] = None
    sd: Optional[torch.Tensor] = None
    sm: Optional[torch.Tensor] = None
    sfactor: int = 0  # groups per superblock (0 = unfactored f32 planes)
    pack_layout: str = "adjk"
    # m -> (environment, choice): pick_mode's settled choices for this weight
    # (not carried to a copy: to() and dataclasses.replace start empty)
    picks: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def to(self, device) -> "QTensor":
        planes = ("qs", "scales", "mins", "perm", "sd", "sm")
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in planes if getattr(self, f) is not None
        })


def _t(a: Optional[np.ndarray], dtype) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def padded_shape(k: int, n: int) -> Tuple[int, int]:
    """(K_pad, N_pad) of a logical (K, N) weight: big dims pad to
    1024-multiples, as the JAX package does, so that the planes compare
    byte for byte (llama's n_ff 11008 -> 11264)."""
    return (_round_up(k, 1024 if k >= 1024 else 256),
            _round_up(n, 1024 if n >= 1024 else 128))


def _pack4_layout() -> str:
    """The nibble layout of weights packed now: CT_PACK4_LAYOUT when it
    names one, else adjk (see the module docstring)."""
    env = os.environ.get("CT_PACK4_LAYOUT")
    return env if env in ("ksplit", "adjk") else "adjk"


def pack4(q: np.ndarray, zp: int, layout: str) -> np.ndarray:
    """(K_pad, N_pad) int8 grid q of a nibble weight -> its (K_pad/2, N_pad)
    bytes in `layout`: int8 for adjk, uint8 for ksplit (the JAX package's
    dtypes)."""
    if layout == "adjk":
        # adjacent rows per byte, both nibbles two's-complement (q + zp - 8)
        nib = (q + np.int8(zp - 8)).view(np.uint8) & np.uint8(0xF)
        return (nib[0::2] | (nib[1::2] << np.uint8(4))).view(np.int8)
    if layout != "ksplit":
        raise ValueError(f"unknown pack layout {layout!r}")
    half = q.shape[0] // 2  # rows pair on the padded K
    nib = (q.astype(np.int16) + zp).astype(np.uint8)
    return (nib[:half] | (nib[half:] << np.uint8(4))) ^ np.uint8(0x80)


def make_qtensor(
    q: np.ndarray,  # (K, N) int8
    s: np.ndarray,  # (K/g, N) f32, or int8 sub-scales when sd is given
    m: Optional[np.ndarray],
    kind: str,
    group: int,
    perm: Optional[np.ndarray] = None,
    sd: Optional[np.ndarray] = None,  # (K/(g*sf), N) f32 superblock scales
    sm: Optional[np.ndarray] = None,
    sfactor: int = 0,
    pack_layout: Optional[str] = None,  # None: _pack4_layout()
) -> QTensor:
    """Pad, pack and wrap host planes as CPU tensors (placement on the
    device is the Engine's job)."""
    k, n = q.shape
    kp, npad = padded_shape(k, n)
    if (kp, npad) != (k, n):
        q = np.pad(q, ((0, kp - k), (0, npad - n)))
        s = np.pad(s, ((0, kp // group - s.shape[0]), (0, npad - n)))
        if m is not None:
            m = np.pad(m, ((0, kp // group - m.shape[0]), (0, npad - n)))
        if sd is not None:
            sb = group * sfactor
            sd = np.pad(sd, ((0, kp // sb - sd.shape[0]), (0, npad - n)))
            if sm is not None:
                sm = np.pad(sm, ((0, kp // sb - sm.shape[0]), (0, npad - n)))
    packed = kind in _PACK4_ZP
    zp = _PACK4_ZP.get(kind, 0)
    layout = (pack_layout or _pack4_layout()) if packed else "adjk"
    if packed:
        q = pack4(q, zp, layout)
    sdtype = np.int8 if sd is not None else np.float32
    return QTensor(
        _t(q, q.dtype),
        _t(s, sdtype),
        _t(m, sdtype),
        kind,
        group,
        (k, n),
        packed,
        zp,
        _t(perm, np.int32),
        sd=_t(sd, np.float32),
        sm=_t(sm, np.float32),
        sfactor=sfactor if sd is not None else 0,
        pack_layout=layout,
    )


def repack(data, t: GGMLType, rows: int, cols: int) -> QTensor:
    """Repack a GGML tensor (file layout: `rows` x `cols`, quant blocks along
    cols) into a QTensor computing x @ W with W logically (cols, rows): the
    load-time transpose, with the k-quant scale factors kept factored and
    the f32 planes of a type without superblocks as they are.

    CT_NO_SFAC (the JAX package's knob for unfactored k-quant planes)
    raises NotImplementedError on a k-quant: the port's k-quant kernels read
    factored planes only. The legacy types, unfactored anyway, load as
    without it, as in the JAX package."""
    t = GGMLType(t)
    n = rows * cols
    q, s, m, group = decompose(data, t, n)
    q = np.ascontiguousarray(q.reshape(rows, cols).T)  # (K=cols, N=rows)
    fac = decompose_factors(data, t, n)
    if fac is not None and os.environ.get("CT_NO_SFAC"):
        raise NotImplementedError(
            f"CT_NO_SFAC: unfactored {t.name} planes are not ported (the k-quant kernels "
            "read int8 sub-scales times f32 superblock factors); unset it"
        )
    if fac is None:  # the legacy types: f32 (K/g, N) planes, sfactor 0
        s = np.ascontiguousarray(s.reshape(rows, cols // group).T)
        if m is not None:
            m = np.ascontiguousarray(m.reshape(rows, cols // group).T)
        return make_qtensor(q, s, m, t.name, group)
    sd, sq, sm, mq, group = fac
    sf = sq.shape[1]  # groups per superblock
    if cols % (group * sf):
        raise ValueError(f"{t.name}: row length {cols} is not a superblock multiple")
    sq = np.ascontiguousarray(sq.reshape(rows, cols // group).T)
    sd = np.ascontiguousarray(sd.reshape(rows, cols // (group * sf)).T)
    if mq is not None:  # Q6_K and Q3_K have no mins
        mq = np.ascontiguousarray(mq.reshape(rows, cols // group).T)
        sm = np.ascontiguousarray(sm.reshape(rows, cols // (group * sf)).T)
    return make_qtensor(q, sq, mq, t.name, group, sd=sd, sm=sm, sfactor=sf)


def unpack_grid(qt: QTensor) -> torch.Tensor:
    """The (K_pad, N_pad) int8 grid q, unpacking nibbles when packed."""
    if not qt.packed:
        return qt.qs
    u = qt.qs.to(torch.int32) & 0xFF
    if qt.pack_layout == "ksplit":
        lo = (u & 0xF) - qt.zp  # rows 0 .. K_pad/2 - 1
        hi = ((u >> 4) ^ 8) - qt.zp  # rows K_pad/2 .., the high nibble sign-biased
        return torch.cat([lo, hi], 0).to(torch.int8)
    # stored nibbles are two's-complement (nib - 8); nib = s4u ^ 8
    lo = ((u & 0xF) ^ 8) - qt.zp  # rows 0, 2, 4, ...
    hi = (((u >> 4) & 0xF) ^ 8) - qt.zp  # rows 1, 3, 5, ...
    rows, n = qt.qs.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * rows, n).to(torch.int8)


def scale_planes(qt: QTensor):
    """f32 (K_pad/g, N_pad) scale/min planes, rebuilt from the superblock
    factors when present (the same f32 multiply decompose performs)."""
    if qt.sfactor == 0:
        return qt.scales, qt.mins
    s = qt.sd.repeat_interleave(qt.sfactor, 0) * qt.scales.float()
    m = None
    if qt.mins is not None:
        m = qt.sm.repeat_interleave(qt.sfactor, 0) * qt.mins.float()
    return s, m


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    """Dense f32 (K, N) view in logical row order."""
    sp, mp_ = scale_planes(qt)
    w = unpack_grid(qt).float() * sp.repeat_interleave(qt.group, 0)
    if mp_ is not None:
        w = w + mp_.repeat_interleave(qt.group, 0)
    k, n = qt.shape
    w = w[:k, :n]
    if qt.perm is not None:
        w = torch.zeros_like(w).index_copy_(0, qt.perm.long(), w)
    return w


# -- matmul ------------------------------------------------------------------


def select_mode(m: int, qt: QTensor) -> str:
    """The kernel mode taken without a measurement for an (m, K_pad) x
    (K_pad, N_pad) product with weight `qt`: on the CPU, under
    CT_QMM_AUTOTUNE=0, and for a key the table does not hold under
    CT_QMM_AUTOTUNE=precompiled (the counterpart of the JAX package's
    heuristic pick). On the card the race of pick_mode decides instead.

    Nibble-packed k-quants (Q4_K; Q2_K and Q3_K at group 16): decode takes
    the in-kernel activation quantization ("qx"), short chunks the
    pre-quantized form ("q"), long chunks the bf16 tensor-core GEMMs,
    folding the bias through the group sums where N is the wider side
    ("si", else "i").

    Nibble-packed weights with plain f32 planes (sfactor 0: GPTQ4 at any
    group, Q4_0, Q4_1) take "qx" at m = 1, "q" at 2 <= m <= 32 and "i" at
    m > 32 on every shape.

    int8 grids (Q6_K, Q5_K, Q8_0, Q5_0, Q5_1): at m <= 32 the
    pre-quantized int8 dot ("q8", the JAX package's "q" mode with
    packed4=False). At m > 32 the candidates are only "b" and "sb", and the
    sum-fold "sb" is dropped where the weight has no mins: "b" for Q6_K,
    Q8_0 and Q5_0, "sb" for Q5_K and Q5_1.

    ksplit nibbles: "sb" at every m, the last of the JAX package's ksplit
    candidates, which its heuristic takes."""
    rows, npad = qt.qs.shape
    if qt.packed and qt.pack_layout == "ksplit":
        return "sb"
    if not qt.packed:
        if m <= 32:
            return "q8"
        return "sb" if qt.mins is not None else "b"
    if m == 1:
        return "qx"
    if m <= 32:
        return "q"
    if qt.sfactor == 0:
        return "i"
    return "si" if npad > 2 * rows else "i"


# -- kernel selection ----------------------------------------------------------
#
# The counterpart of the JAX package's _tile_candidates / _pick_tiles /
# autotune. A choice is ("dense",) or (mode, config): `mode` names the
# kernel (qmm_kernels.kernel_name), `config` its launch configuration
# (qmm_kernels.CONFIG_OF; the TPU tile numbers of the JAX lists are Mosaic
# block sizes and have no meaning here). Environment, read at call time:
#
#   CT_QMM_AUTOTUNE    "1" (default) race a key's candidates on the card at
#                      first use; "0" no table and no race, select_mode
#                      decides; "precompiled" trust the tables, select_mode
#                      for a key they do not hold, never race
#   CT_QMM_TILE_CACHE  the user's table file
#   CT_QMATMUL         "kernels": no dense candidate, a key takes its best
#                      hand-written kernel; "dense": never a kernel

DENSE = ("dense",)
# adjk nibbles (Q4_K, Q2_K, Q3_K, GPTQ4, Q4_0, Q4_1), ksplit nibbles (the
# same kinds) and int8 grids (Q6_K, Q5_K, Q8_0, Q5_0, Q5_1), in the order of
# the JAX package's candidate lists ("q8" is its "q" with packed4=False).
# The reshape-broadcast modes "r" and "rb" are in no list, as in the JAX
# package, nor is "qx" on an int8 grid; a table may name them
# (rb_mode_entries, qx_mode_entries)
_NIBBLE_MODES = ("i", "si", "g", "q", "qx")
_KSPLIT_MODES = ("", "s", "b", "sb")
_GRID_MODES = ("", "s", "b", "sb", "g", "q8")
TABLE_FORMAT = "ctransformers_tpu_torch qmm modes v1"
# torch.cuda.get_device_name -> the table shipped under data/
_SHIPPED_TABLES = {"NVIDIA H100 80GB HBM3": "h100"}

# (card, user's table path) -> {key: {"pick": choice, "kernel": best
# hand-written choice or None, "ms": {candidate: ms}}}: one table per card
# and user file, filled at first use from that file and the table shipped
# for the card (table) and by races, so that a CPU engine beside a CUDA one
# neither re-reads a file nor loses a raced entry
_TILE_CACHE: Dict[tuple, Dict[tuple, dict]] = {}
# (card, user's table path, key) of entries that are not the champion of a
# full race (a race without the dense candidate): kept in memory, never
# written to the user's table
_TAINTED_KEYS: set = set()
N_RACES = 0  # races run by this process


def _autotune_mode() -> str:
    return os.environ.get("CT_QMM_AUTOTUNE", "1")


def _force() -> Optional[str]:
    return os.environ.get("CT_QMATMUL")


@functools.lru_cache(maxsize=None)
def _default_table_path() -> str:
    return os.path.expanduser("~/.cache/ctransformers_tpu_torch/qmm_modes_v1.json")


def table_path() -> str:
    return os.environ.get("CT_QMM_TILE_CACHE") or _default_table_path()


@functools.lru_cache(maxsize=None)
def card_name(device: torch.device) -> str:
    """The name a table must carry to serve `device`."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def cache_key(m: int, qt: QTensor) -> tuple:
    """The JAX package's key: storage rows (byte rows of a nibble-packed
    weight), padded N, group, has mins, the real m, packed, sfactor, layout.
    Q4_K and GPTQ4 at group 32 differ in sfactor, Q2_K and Q3_K (group 16,
    sfactor 16) in mins and from Q6_K in packing, fused and unfused QKV in
    N. Q4_1 shares GPTQ4 group 32's keys and Q5_0 shares Q8_0's: the same
    layout runs the same kernels."""
    rows, npad = qt.qs.shape
    return (int(rows), int(npad), qt.group, qt.mins is not None, int(m), qt.packed,
            qt.sfactor, qt.pack_layout)


def mode_candidates(qt: QTensor, m: int) -> List[tuple]:
    """The (mode, config) candidates raced for `qt` at batch size m: the
    mode axis of the JAX package's candidate lists in their order, pruned at
    m > 32 to the bf16 tensor-core modes (those ending in "b", and "i" and
    "si"), without the sum-fold modes on an int8 grid without mins. A
    nibble-packed weight keeps "si" whatever its bias, as the JAX package's
    list does (ctransformers_tpu/ops/qmatmul.py:_pick_tiles): on Q4_0, whose
    bias is 0, "si" computes what "i" does. A ksplit weight keeps "s" and
    "sb" too: its low half has a bias on every kind (-8 s on Q4_0 and
    Q3_K), and it never takes the grouped modes, which the JAX package
    refuses on that layout."""
    if qt.packed:
        modes = _KSPLIT_MODES if qt.pack_layout == "ksplit" else _NIBBLE_MODES
    else:
        modes = _GRID_MODES
    if m > 32:
        modes = tuple(x for x in modes if x.endswith("b") or x in ("i", "si"))
    if not (qt.packed or qt.mins is not None):
        modes = tuple(x for x in modes if "s" not in x)
    return [(x, kern.CONFIG_OF[kern.kernel_name(x, qt)]) for x in modes]


def _heuristic(m: int, qt: QTensor) -> tuple:
    mode = select_mode(m, qt)
    return (mode, kern.CONFIG_OF[kern.kernel_name(mode, qt)])


def _parse_cache_file(path: str, card: str) -> Dict[tuple, dict]:
    """The entries of a table file, or none when it was written for another
    card or from other kernel sources (a rewritten kernel must not be
    served a stale champion)."""
    with open(path) as f:
        doc = json.load(f)
    if (not isinstance(doc, dict) or doc.get("format") != TABLE_FORMAT
            or doc.get("card") != card or doc.get("source_hash") != kern._source_hash()):
        return {}
    out = {}
    for k, v in doc.get("modes", {}).items():
        rows, npad, g, has_m, m, packed, sf, layout = k.split(",")
        key = (int(rows), int(npad), int(g), has_m == "True", int(m), packed == "True",
               int(sf), layout)
        kernel = v.get("kernel")
        out[key] = {"pick": tuple(v["pick"]), "kernel": kernel and tuple(kernel),
                    "ms": dict(v.get("ms", {}))}
    return out


def shipped_table_path(card: str) -> Optional[str]:
    slug = _SHIPPED_TABLES.get(card)
    if slug is None:
        return None
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", f"qmm_modes_{slug}.json")


def _load_shipped_cache(card: str, entries: Dict[tuple, dict]) -> None:
    """Merge the packaged table of this card; the user's entries win."""
    path = shipped_table_path(card)
    if path is not None and os.path.exists(path):
        for k, v in _parse_cache_file(path, card).items():
            entries.setdefault(k, v)


def _load_disk_cache(card: str, path: str, entries: Dict[tuple, dict]) -> None:
    if os.path.exists(path):
        try:
            entries.update(_parse_cache_file(path, card))
        except (ValueError, KeyError, TypeError) as e:
            logger.warning("qmm table %s is unreadable and ignored: %r", path, e)


def table(device: torch.device) -> Dict[tuple, dict]:
    """The entries in force for `device` under the user's table file named
    now: read from that file and the shipped table the first time this
    (card, file) is asked for, then kept (with what was raced since)."""
    ident = (card_name(device), table_path())
    entries = _TILE_CACHE.get(ident)
    if entries is None:
        entries = _TILE_CACHE[ident] = {}
        _load_disk_cache(*ident, entries)
        _load_shipped_cache(ident[0], entries)
    return entries


@functools.lru_cache(maxsize=None)
def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi prints it (None without one)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines() if r.returncode == 0 else []
    return lines[0].strip() if lines else None


def save_table(path: str, card: str, entries: Dict[tuple, dict],
               limit: Optional[str] = None) -> None:
    """Write `entries` as a table file for `card` and this checkout's kernel
    sources."""
    doc = {
        "format": TABLE_FORMAT, "card": card, "power_limit": limit,
        "source_hash": kern._source_hash(),
        "modes": {
            ",".join(map(str, k)): {
                "pick": list(v["pick"]),
                "kernel": None if v.get("kernel") is None else list(v["kernel"]),
                "ms": v.get("ms", {}),
            }
            for k, v in sorted(entries.items())
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def _save_disk_cache(card: str) -> None:
    path = table_path()
    entries = {k: v for k, v in _TILE_CACHE.get((card, path), {}).items()
               if (card, path, k) not in _TAINTED_KEYS}
    try:
        save_table(path, card, entries, power_limit())
    except OSError as e:  # a read-only home: the champions stay in memory
        logger.warning("qmm table %s not written: %r", path, e)


def _qmm_dense(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The dense candidate, the counterpart of the JAX package's XLA
    dequantize-and-matmul: the whole grid times its scales rounded to bf16,
    a bf16 x bf16 -> f32 torch.matmul, and the mins through the f32 group
    sums of x. Plain tensor code in the JAX package too (outside every
    Pallas kernel); x is (m, K_pad), the result the padded (m, N_pad)."""
    sp, mp_ = scale_planes(qt)
    w = (unpack_grid(qt).float() * sp.repeat_interleave(qt.group, 0)).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    if x.is_cuda:
        out = torch.mm(xb, w, out_dtype=torch.float32)
    else:  # a CPU bf16 matmul returns bf16: multiply the rounded operands in f32
        out = xb.float() @ w.float()
    if mp_ is not None:
        out = out + x.reshape(x.shape[0], -1, qt.group).sum(-1) @ mp_
    return out


def _apply(choice: tuple, xm: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The padded product (m, N_pad) by `choice`; xm is (m, K_pad) f32."""
    if choice == DENSE:
        kern.DENSE_CALLS["dense"] += 1
        return _qmm_dense(xm, qt)
    # looked up at call time, so that a caller may wrap the module's kernels
    name = kern.kernel_name(choice[0], qt)
    fn = getattr(kern, name)
    if name in kern.PREQUANTIZED:
        return fn(*kern.quantize_activations(xm, qt.group), qt)
    return fn(xm, qt)


def label(choice: tuple) -> str:
    """A choice's name in logs and in a table's "ms": its mode ("f" for the
    empty mode), or "dense"."""
    return choice[0] or "f"


def race(m: int, qt: QTensor, peers: Optional[Sequence[QTensor]] = None,
         dense: bool = True) -> dict:
    """Time every candidate of `qt` at batch size m on the card and return
    {"pick": fastest, "kernel": fastest hand-written, "ms": {label: ms}}.

    Each candidate is timed as qmatmul would run it (activation
    quantization included) from a replayed CUDA graph between two CUDA
    events, so the host's launch cost does not rank candidates. The graph's
    calls rotate over `peers`, the weights of the same key (an engine's 32
    layers: more than the card's 50 MB L2, so the planes stream from device
    memory as they do in decode); a key with one weight replays that one.
    Two passes over the candidates, three timed replays a visit, the least
    time kept. A candidate that fails to build or launch raises: it is not
    dropped from the race."""
    global N_RACES
    peers = list(peers or [qt])
    dev = qt.qs.device
    if dev.type != "cuda":
        raise ValueError(f"race: weights on {dev}; candidates are timed on CUDA only")
    cands = mode_candidates(qt, m) + ([DENSE] if dense else [])
    kp = qt.qs.shape[0] * (2 if qt.packed else 1)
    x = torch.randn((m, kp), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    reps = max(len(peers), 8)
    runs = []
    with torch.inference_mode():
        for cand in cands:
            _apply(cand, x, qt)  # builds, warms, and raises what does not launch
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for i in range(reps):
                    _apply(cand, x, peers[i % len(peers)])
            runs.append(graph)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        best = [float("inf")] * len(cands)
        for _ in range(2):
            for i, graph in enumerate(runs):
                graph.replay()  # warm
                for _ in range(3):
                    e0.record()
                    graph.replay()
                    e1.record()
                    torch.cuda.synchronize(dev)
                    best[i] = min(best[i], e0.elapsed_time(e1) / reps)
    del runs
    N_RACES += 1
    ms = {label(c): t for c, t in zip(cands, best)}
    order = sorted(range(len(cands)), key=best.__getitem__)
    kernel = next(cands[i] for i in order if cands[i] != DENSE)
    res = {"pick": cands[order[0]], "kernel": kernel, "ms": ms}
    logger.info("qmm race %s: %s -> %s", cache_key(m, qt),
                " ".join(f"{k}={v:.4f}" for k, v in ms.items()), label(res["pick"]))
    return res


def pick_mode(m: int, qt: QTensor, peers: Optional[Sequence[QTensor]] = None) -> tuple:
    """The choice for x (m, K) @ qt: the table's, or on a miss a race on the
    card (CT_QMM_AUTOTUNE=1), else select_mode's. See the section comment
    for the environment. A settled choice is kept on the weight per m and
    environment (pick_stamp), so that a served forward pays three
    environment reads and a dictionary lookup per matmul. A key that would
    race while a CUDA graph is captured raises: the race cannot run there,
    and the fixed rule's choice would be baked into the graph."""
    stamp = pick_stamp()
    kept = qt.picks.get(m)
    if kept is not None and kept[0] == stamp:
        return kept[1]
    choice = _resolve(m, qt, peers)
    if choice is None:
        raise RuntimeError(
            f"pick_mode: key {cache_key(m, qt)} is not settled under {stamp} while a CUDA "
            "graph is captured; settle it first (autotune, or one eager call)")
    qt.picks[m] = (stamp, choice)
    return choice


# the environment pick_mode reads: a settled choice holds under these values
PICK_SETTINGS = ("CT_QMM_AUTOTUNE", "CT_QMATMUL", "CT_QMM_TILE_CACHE")


def pick_stamp() -> tuple:
    """The values of PICK_SETTINGS now (None where unset)."""
    env = os.environ
    return tuple(env.get(k) for k in PICK_SETTINGS)


def _resolve(m: int, qt: QTensor, peers: Optional[Sequence[QTensor]]) -> Optional[tuple]:
    """pick_mode's choice, or None for a key the tables do not hold while a
    CUDA graph is captured (no race may run there)."""
    force = _force()
    if force == "dense":
        return DENSE
    auto = _autotune_mode()
    if auto == "0":
        return _heuristic(m, qt)
    dev = qt.qs.device
    entries = table(dev)
    key = cache_key(m, qt)
    hit = entries.get(key)
    if hit is not None:
        if force != "kernels" or hit["pick"] != DENSE:
            return hit["pick"]
        if hit["kernel"] is not None:
            return hit["kernel"]
    if dev.type != "cuda" or auto == "precompiled":
        # never stored in the table: a later run that may race finds the key open
        return _heuristic(m, qt)
    if torch.cuda.is_current_stream_capturing():
        return None
    res = race(m, qt, peers, dense=force != "kernels")
    entries[key] = res
    tainted = (card_name(dev), table_path(), key)
    if force == "kernels":
        _TAINTED_KEYS.add(tainted)  # no dense candidate was timed: not a champion
    else:
        _TAINTED_KEYS.discard(tainted)
        _save_disk_cache(card_name(dev))
    return res["pick"]


def qtensors(params) -> List[QTensor]:
    """Every QTensor of an engine's params (layers first, then the rest)."""
    out = [w for layer in params.get("layers", []) for w in layer.values()
           if isinstance(w, QTensor)]
    return out + [w for w in params.values() if isinstance(w, QTensor)]


def float_mode_entries(qts: Sequence[QTensor], sizes: Sequence[int]) -> Dict[tuple, dict]:
    """Table entries that steer every key of the weights `qts` at the batch
    sizes `sizes` to the float-activation kernels and the sum-fold GEMMs,
    whatever a race would pick: a table under which a model runs those
    kernels (save_table, then CT_QMM_TILE_CACHE with
    CT_QMM_AUTOTUNE=precompiled). adjk nibbles: g at m <= 32, si above.
    ksplit nibbles (no grouped dot): "" and s in turn over the keys and
    sizes at m <= 32, b and sb in turn above. int8 grids at m <= 32: "", g
    and (with mins) s in turn over the keys and sizes; above 32 sb where
    there are mins, else no entry (the rule's b)."""
    entries = {}
    grids = sorted({cache_key(0, w) for w in qts if not w.packed})
    ksplit = sorted({cache_key(0, w) for w in qts if w.packed and w.pack_layout == "ksplit"})
    for w in qts:
        for j, m in enumerate(sizes):
            if w.packed and w.pack_layout == "ksplit":
                modes = ["", "s"] if m <= 32 else ["b", "sb"]
                mode = modes[(ksplit.index(cache_key(0, w)) + j) % 2]
            elif w.packed:
                mode = "g" if m <= 32 else "si"
            elif m <= 32:
                modes = ["", "g"] + (["s"] if w.mins is not None else [])
                mode = modes[(grids.index(cache_key(0, w)) + j) % len(modes)]
            elif w.mins is not None:
                mode = "sb"
            else:
                continue
            choice = (mode, kern.CONFIG_OF[kern.kernel_name(mode, w)])
            entries[cache_key(m, w)] = {"pick": choice, "kernel": choice, "ms": {}}
    return entries


def rb_mode_entries(qts: Sequence[QTensor], sizes: Sequence[int]) -> Dict[tuple, dict]:
    """Table entries that steer every ksplit key and every int8-grid key of
    the weights `qts` at the batch sizes `sizes` to the reshape-broadcast
    kernels, which no race picks (they are no candidate, as in the JAX
    package): "r" (f32 dots) at m <= 32, "rb" (bf16 operands) above. adjk
    nibble keys get no entry (the rule's choice)."""
    entries = {}
    for w in qts:
        if w.packed and w.pack_layout != "ksplit":
            continue
        for m in sizes:
            mode = "r" if m <= 32 else "rb"
            choice = (mode, kern.CONFIG_OF[kern.kernel_name(mode, w)])
            entries[cache_key(m, w)] = {"pick": choice, "kernel": choice, "ms": {}}
    return entries


def qx_mode_entries(qts: Sequence[QTensor], sizes: Sequence[int]) -> Dict[tuple, dict]:
    """Table entries that steer every int8-grid key (Q6_K, Q5_K, Q8_0, Q5_0,
    Q5_1) of the weights `qts` at the batch sizes `sizes` up to 32 to "qx",
    the activations quantized inside the kernel (qmm_qx8, qmm_qx8_legacy),
    which no race picks (no JAX candidate list offers it on an unpacked
    grid). Nibble keys, ksplit keys and sizes above 32 get no entry."""
    entries = {}
    for w in qts:
        if w.packed:
            continue
        for m in sizes:
            if m <= 32:
                choice = ("qx", kern.CONFIG_OF[kern.kernel_name("qx", w)])
                entries[cache_key(m, w)] = {"pick": choice, "kernel": choice, "ms": {}}
    return entries


def autotune(params, batch_sizes: Sequence[int] = (1,)) -> dict:
    """Pick the kernel of every QTensor of `params` at each batch size
    before it is served (the engine calls this at load for m = 1 and
    before the first prompt chunk of each size), so that no race runs
    inside a timed or captured forward. Weights that share a key are raced
    together, the timed calls rotating over them. Returns {"raced": keys
    raced now, "warm": keys the tables held, "seconds"}; off the card, under
    CT_QMM_AUTOTUNE=0 and under CT_QMATMUL=dense it does nothing."""
    t0 = time.perf_counter()
    stats = {"raced": 0, "warm": 0, "seconds": 0.0}
    qts = qtensors(params)
    if (not qts or qts[0].qs.device.type != "cuda" or _autotune_mode() == "0"
            or _force() == "dense"):
        return stats
    groups: Dict[tuple, List[QTensor]] = {}
    for qt in qts:
        groups.setdefault(cache_key(0, qt), []).append(qt)
    entries = table(qts[0].qs.device)
    for m in batch_sizes:
        for peers in groups.values():
            before = N_RACES
            known = cache_key(m, peers[0]) in entries
            pick_mode(m, peers[0], peers)
            if N_RACES > before:
                stats["raced"] += 1
            elif known:
                stats["warm"] += 1
    stats["seconds"] = time.perf_counter() - t0
    return stats


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for dense tensors or QTensor weights; x is (..., K)."""
    if isinstance(w, QTensor):
        return qmatmul(x, w)
    return x @ w


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    lead = x.shape[:-1]
    k, n = qt.shape
    xm = x.reshape(-1, k).float()
    if qt.perm is not None:
        # act-order row gather (GPTQ): plain tensor code in the JAX package
        # too, outside its kernels
        xm = xm.index_select(1, qt.perm)
    kp = qt.qs.shape[0] * (2 if qt.packed else 1)
    if kp != k:
        xm = torch.nn.functional.pad(xm, (0, kp - k))
    xm = xm.contiguous()
    out = _apply(pick_mode(xm.shape[0], qt), xm, qt)
    return out[:, :n].reshape(*lead, n)


# -- fusion --------------------------------------------------------------------


def concat_qtensors(qts) -> Optional[QTensor]:
    """Fuse column-wise compatible QTensors into one wide weight so one
    kernel call serves several projections (QKV, gate+up). Returns None when
    fusion does not apply (mixed formats, dense weights, perms, other K)."""
    if len(qts) < 2 or not all(isinstance(q, QTensor) for q in qts):
        return None
    head = qts[0]
    for q in qts:
        if (
            q.kind != head.kind
            or q.group != head.group
            or q.packed != head.packed
            or q.zp != head.zp
            or q.perm is not None
            or q.qs.shape[0] != head.qs.shape[0]
            or q.shape[0] != head.shape[0]
            or q.pack_layout != head.pack_layout
            or (q.mins is None) != (head.mins is None)
            or q.sfactor != head.sfactor
        ):
            return None

    def cat(field):
        if getattr(head, field) is None:
            return None
        return torch.cat([getattr(q, field) for q in qts], dim=1)

    splits = tuple((int(q.qs.shape[1]), int(q.shape[1])) for q in qts)
    qs = cat("qs")
    return QTensor(
        qs,
        cat("scales"),
        cat("mins"),
        head.kind,
        head.group,
        (head.shape[0], int(qs.shape[1])),  # logical N = padded total
        head.packed,
        head.zp,
        splits=splits,
        sd=cat("sd"),
        sm=cat("sm"),
        sfactor=head.sfactor,
        pack_layout=head.pack_layout,
    )


def split_fused(out: torch.Tensor, qt: QTensor):
    """Slice a fused matmul output back into per-projection tensors."""
    parts = []
    off = 0
    for npad_i, n_i in qt.splits:
        parts.append(out[..., off : off + n_i])
        off += npad_i
    return parts


def fuse_layer_params(params) -> int:
    """Fuse wq/wk/wv -> w_qkv and w_gate/w_up -> w_gateup in place where
    compatible. Returns the number of fused groups created."""
    n = 0
    for layer in params.get("layers", []):
        if all(k in layer for k in ("wq", "wk", "wv")) and "w_qkv" not in layer:
            fused = concat_qtensors([layer["wq"], layer["wk"], layer["wv"]])
            if fused is not None:
                layer["w_qkv"] = fused
                del layer["wq"], layer["wk"], layer["wv"]
                n += 1
        if all(k in layer for k in ("w_gate", "w_up")) and "w_gateup" not in layer:
            fused = concat_qtensors([layer["w_gate"], layer["w_up"]])
            if fused is not None:
                layer["w_gateup"] = fused
                del layer["w_gate"], layer["w_up"]
                n += 1
    return n
