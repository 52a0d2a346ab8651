"""One whole MRF stage of the generator: CUDA kernel, entry points and plain version.

Counterpart of `mri2speech_tpu/ops/pallas_mrf.py`: K3a `mrf_stage_pallas_v2`
(:259, compact ``(B, T, C)`` input: every branch starts from the same x) and
K3b `mrf_stage_pallas` (:352, branch-tiled ``(B, T, nb*C)`` input: branch j
starts from its own slice). One kernel, `csrc/mrf_stage.cu`, serves both;
the source says what bounds it.

A stage is ``nb`` ResBlock1 branches (kernels 3/7/11), each ``len(dils)``
units of leaky -> causal dilated conv -> leaky -> causal conv -> residual
add, then the branch mean. The numbers are the TPU kernel's: activations
are rounded to ``mxu_dtype`` right after leaky, just before each product,
the weights are held in ``mxu_dtype``, and the accumulation, bias, residual
and mean are fp32. ``mxu_dtype=torch.float32`` gives the fp32 stage. The
plain version, :func:`mrf_stage_reference`, runs each branch with
``F.conv1d`` on the same rounded operands; it is not the unfused fp32 stack.

The entry points keep the JAX signatures and the ``(B, T, C)`` layout;
``layout="bct"`` takes and returns the generator's ``(B, C, T)`` instead, with
no copy. ``packed`` is the JAX package's per-tap block-diagonal layout
(:func:`pack_mrf_stage_params`), or an :class:`MRFStageWeights`, which holds
the per-branch taps and caches the kernel's layout per operand type and
device, so the conversion stays out of the call. x is fp32 or bf16: the
stage computes in fp32 and returns x's type, as the JAX functions do (the
kernel reads and writes x's type itself).

The kernel's tiling is chosen here, by :func:`tile_plan`, which mirrors the
geometry of `csrc/mrf_stage.cu` (rows, shared memory, CTAs) so the CPU tests
can check it. A CUDA tensor launches the kernel, or raises (also where the
plan cannot take the shape). A CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mri2speech_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
MXU_DTYPES = (torch.bfloat16, torch.float32)
IO_DTYPES = (torch.float32, torch.bfloat16)

# Calls of the CUDA kernel per entry point (one per stage, whatever its internal
# launches); the plain version is never counted.
launches = {"mrf_stage_pallas": 0, "mrf_stage_pallas_v2": 0}

# The kernel's limits and geometry (csrc/mrf_stage.cu)
HALO = 128          # the JAX kernel's halo (pallas_mrf.py:42): receptive fields up to it
MAX_NB = 4
MAX_UNITS = 8
MAX_STAGES = 8
MAX_NP = 8          # CTAs a cluster
NWG = 3             # warpgroups a CTA
UNIT_NW = {torch.bfloat16: (128, 64, 32), torch.float32: (64, 32)}  # unit mode's channels a CTA
SMS = 132           # H100 SXM streaming multiprocessors
SMEM_LIMIT = 232448


def stage_receptive_field(kernels: Sequence[int], dils: Sequence[int]) -> int:
    """Left context consumed by one branch's full unit chain (max over branches)."""
    return max(sum((k - 1) * d + (k - 1) for d in dils) for k in kernels)


def pack_mrf_stage_params(
    resblocks: Sequence[dict], kernels: Sequence[int], dils: Sequence[int]
) -> dict:
    """Per-branch ResBlock1 params -> the JAX per-tap block-diagonal layout.

    resblocks[j] = {"convs1_u": {"w": (k_j, C, C), "b": (C,)}, "convs2_u": ...}
    (the weight-norm-folded JAX layout, (tap, in, out)). Returns, per unit u
    and conv c, "u{u}_c{c}_w" (k_max, nb*C, nb*C), whose tap m holds branch j's
    W_j[k_j-1-m] on diagonal block j while m < k_j, and "u{u}_c{c}_b" (1, nb*C).
    """
    nb = len(kernels)
    k_max = max(kernels)
    C = np.asarray(resblocks[0]["convs1_0"]["w"]).shape[1]
    packed = {}
    for u in range(len(dils)):
        for c, conv_list in ((1, "convs1"), (2, "convs2")):
            w_p = np.zeros((k_max, nb * C, nb * C), np.float32)
            b_p = np.zeros((1, nb * C), np.float32)
            for j, k in enumerate(kernels):
                p = resblocks[j][f"{conv_list}_{u}"]
                w = np.asarray(p["w"], np.float32)
                for m in range(k):
                    w_p[m, j * C:(j + 1) * C, j * C:(j + 1) * C] = w[k - 1 - m]
                b_p[0, j * C:(j + 1) * C] = np.asarray(p["b"], np.float32)
            packed[f"u{u}_c{c}_w"] = w_p
            packed[f"u{u}_c{c}_b"] = b_p
    return packed


def unpack_mrf_stage_params(
    packed: dict, kernels: Sequence[int], dils: Sequence[int]
) -> List[dict]:
    """Inverse of :func:`pack_mrf_stage_params`: W_j[t] = packed[k_j-1-t] on diagonal block j.

    Raises ValueError if an off-diagonal block, or a tap m >= k_j of branch j,
    is non-zero: such a packing is no stage of separate branches.
    """
    nb = len(kernels)
    k_max = max(kernels)
    out: List[dict] = [{} for _ in kernels]
    for u in range(len(dils)):
        for c, conv_list in ((1, "convs1"), (2, "convs2")):
            w_p = np.asarray(packed[f"u{u}_c{c}_w"], np.float32)
            b_p = np.asarray(packed[f"u{u}_c{c}_b"], np.float32).reshape(-1)
            if w_p.ndim != 3 or w_p.shape[0] != k_max or w_p.shape[1] != w_p.shape[2] \
                    or w_p.shape[1] % nb or b_p.shape != (w_p.shape[1],):
                raise ValueError(
                    f"u{u}_c{c}: expected w (k_max={k_max}, nb*C, nb*C) and b (1, nb*C) "
                    f"for nb={nb}, got {w_p.shape} and {b_p.shape}"
                )
            C = w_p.shape[1] // nb
            rest = w_p.copy()
            for j, k in enumerate(kernels):
                blk = slice(j * C, (j + 1) * C)
                out[j][f"{conv_list}_{u}"] = {
                    "w": np.stack([w_p[k - 1 - t, blk, blk] for t in range(k)]),
                    "b": b_p[blk].copy(),
                }
                rest[:k, blk, blk] = 0.0
            if np.any(rest):
                m, r, q = np.argwhere(rest)[0]
                raise ValueError(
                    f"u{u}_c{c}: non-zero entry at tap {m}, row {r}, column {q} outside "
                    f"the diagonal blocks of branches with kernels {tuple(kernels)}"
                )
    return out


class MRFStageWeights:
    """The taps of one stage, per branch, and their kernel layout per operand type.

    weights[u][c][j] is the torch conv weight (C, C, k_j) of unit u, conv c
    (0: the dilated conv, 1: the d=1 conv), branch j; biases[u][c][j] is (C,).
    """

    def __init__(self, weights, biases, kernels: Sequence[int], dils: Sequence[int]) -> None:
        self.kernels = tuple(int(k) for k in kernels)
        self.dils = tuple(int(d) for d in dils)
        self.weights = [[[w.detach().float() for w in per_c] for per_c in per_u]
                        for per_u in weights]
        self.biases = [[[b.detach().float() for b in per_c] for per_c in per_u]
                       for per_u in biases]
        self.channels = int(self.weights[0][0][0].shape[0])
        for u, per_u in enumerate(self.weights):
            for c, per_c in enumerate(per_u):
                for j, w in enumerate(per_c):
                    want = (self.channels, self.channels, self.kernels[j])
                    if tuple(w.shape) != want:
                        raise ValueError(f"unit {u} conv {c} branch {j}: weight "
                                         f"{tuple(w.shape)}, expected {want}")
        if len(self.weights) != len(self.dils):
            raise ValueError(f"{len(self.weights)} units of weights for dilations {self.dils}")
        self._kernel: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_resblocks(cls, resblocks: Sequence[dict], kernels, dils) -> "MRFStageWeights":
        """From the JAX per-branch layout {"convs{1,2}_u": {"w": (k, in, out), "b": (C,)}}."""

        def convs(key):  # [u][c][j] of the (k, in, out) -> (out, in, k) weights, or of the biases
            return [[[torch.from_numpy(np.array(
                blk[f"convs{c + 1}_{u}"][key], np.float32).T.copy()) for blk in resblocks]
                for c in range(2)] for u in range(len(dils))]

        return cls(convs("w"), convs("b"), kernels, dils)

    @classmethod
    def from_packed(cls, packed: dict, kernels, dils) -> "MRFStageWeights":
        return cls.from_resblocks(unpack_mrf_stage_params(packed, kernels, dils), kernels, dils)

    def conv(self, u: int, c: int, j: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.weights[u][c][j].to(device), self.biases[u][c][j].to(device)

    def kernel_layout(self, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(taps, biases) as `csrc/mrf_stage.cu` reads them, built once per (dtype, device).

        :func:`tap_layout` of the taps in ``dtype``; biases fp32 (2 * units, nb, C).
        """
        key = (dtype, torch.device(device))
        if key not in self._kernel:
            bs = [b for per_u in self.biases for per_c in per_u for b in per_c]
            self._kernel[key] = (
                tap_layout(self, dtype).to(device=device).contiguous(),
                torch.cat(bs).to(device=device, dtype=torch.float32).contiguous(),
            )
        return self._kernel[key]


def padded_channels(C: int) -> int:
    """Input channels padded for the kernel's products: a multiple of its K slice."""
    return -(-C // 16) * 16 if C <= 32 else -(-C // 32) * 32 if C <= 64 else -(-C // 64) * 64


def k_slice(Kp: int, dtype: torch.dtype) -> int:
    """Input channels of one ring stage: 64 (bf16) or 32 (fp32) at most."""
    return min(Kp, 64 if dtype == torch.bfloat16 else 32)


def _kdim(KS: int, dtype: torch.dtype) -> int:
    """A stage's row pitch in elements: bf16 in wgmma's core-matrix layout, fp32 rows KS + 4 apart."""
    return KS if dtype == torch.bfloat16 else KS + 4


def _core_index(rows: int, K: int) -> np.ndarray:
    """Position of element (r, k) of a rows x K tile in wgmma's core-matrix layout (hopper.cuh)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(K), indexing="ij")
    return (r >> 3) * (K * 8) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7)


def tap_layout(weights: "MRFStageWeights", dtype: torch.dtype) -> torch.Tensor:
    """The stage's taps as the kernel's ring reads them, flat in ``dtype`` (on the CPU).

    For conv q = 2u + c, branch j, tap m (applied to input row t - m*d: the torch
    weight's index k_j - 1 - m) and K slice s, one tile of Kp output channels x
    KS input channels (:func:`padded_channels`, :func:`k_slice`), zero past C,
    at ((q * sum(k) + sum_{i<j} k_i + m) * Kp / KS + s) * Kp * kdim: bf16 in
    wgmma's core-matrix layout (kdim = KS), fp32 row-major with rows KS + 4
    apart. A CTA's output channels p*NW .. + NW are one contiguous part of a
    tile, whatever NW.
    """
    C = weights.channels
    Kp = padded_channels(C)
    KS = k_slice(Kp, dtype)
    kdim = _kdim(KS, dtype)
    tiles = []
    for per_u in weights.weights:
        for per_c in per_u:
            for w in per_c:  # (C, C, k): w[co, ci, k - 1 - m] is tap m
                taps = torch.zeros(w.shape[2], Kp, Kp)
                taps[:, :C, :C] = w.flip(-1).permute(2, 0, 1)
                # (m, co, s, ci) -> (m, s, co, ci)
                tiles.append(taps.reshape(-1, Kp, Kp // KS, KS).permute(0, 2, 1, 3))
    t = torch.cat(tiles).to(dtype)  # (sum over convs of k, NS, Kp, KS)
    out = torch.zeros(t.shape[0], t.shape[1], Kp * kdim, dtype=dtype)
    if dtype == torch.bfloat16:
        out[:, :, torch.from_numpy(_core_index(Kp, KS).reshape(-1))] = t.reshape(*t.shape[:2], -1)
    else:
        out.view(*t.shape[:2], Kp, kdim)[..., :KS] = t
    return out.reshape(-1)


def tiles_a_warpgroup(nw: int, C: int, dtype: torch.dtype) -> int:
    """64-row output tiles a warpgroup of the kernel holds: 1 at 128 channels, 2 where the
    accumulator or the A fragments of a tile are large (64 channels, or a K slice of 64
    bf16), else 4."""
    if nw == 128:
        return 1
    big = nw == 64 or (dtype == torch.bfloat16 and k_slice(padded_channels(C), dtype) == 64)
    return 2 if big else 4


def _reach(q: int, k: int, dils: Sequence[int]) -> int:
    """Rows the taps of conv q = 2u + c reach back."""
    return k - 1 if q % 2 else (k - 1) * dils[q // 2]


def branch_rows(k: int, dils: Sequence[int], q0: int, q1: int, TM: int) -> Tuple[int, List[int]]:
    """(buffer rows, tiles per conv) of a TM-row tile through convs q0 .. q1-1 (mrf_stage.cu::rows_of).

    Conv q computes n_q 64-row tiles aligned at the tile's end: the TM rows plus
    what the later convs reach back; it reads reach(q) rows below them.
    """
    h = sum(_reach(q, k, dils) for q in range(q0, q1))
    rows, n = 0, []
    for q in range(q0, q1):
        r = _reach(q, k, dils)
        h -= r
        n.append(-(-(TM + h) // 64))
        rows = max(rows, 64 * n[-1] + r)
    return -(-rows // 8) * 8, n


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(rows: int, tm: int, C: int, nw: int, dtype: torch.dtype, chain: bool,
               stages: int) -> int:
    """Shared memory of a CTA (mrf_stage.cu::Smem): mbarriers, tap ring, operand tile,
    fp32 state (chain mode: every buffer row and channel; unit mode: the tile's tm rows
    of the CTA's nw channels)."""
    Kp = padded_channels(C)
    bf = dtype == torch.bfloat16
    es = 2 if bf else 4
    stage = nw * _kdim(k_slice(Kp, dtype), dtype) * es
    act = _round128(rows * (Kp + (8 if bf else 4)) * es)
    state = rows * (Kp + 4) if chain else tm * (nw + 4)
    return _round128(16 * MAX_STAGES) + stages * _round128(stage) + act + 4 * state


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How the kernel cuts one stage: chain mode (one launch runs every unit, C <= 64)
    or unit mode (one launch a unit, the output channels split over clusters of
    ``np`` CTAs of ``nw`` channels); branch j in time tiles of ``tm[j]`` rows,
    the branches' CTAs launched in ``order``; a tap ring of ``stages``."""

    chain: bool
    nw: int
    np: int
    tm: Tuple[int, ...]
    order: Tuple[int, ...]
    stages: int
    rows: int          # buffer rows of the largest tile
    smem: int          # bytes a CTA
    ctas: int          # a launch
    kernel_launches: int  # a stage, the branch mean's included

    def tiles(self, T: int) -> Tuple[Tuple[int, int], ...]:
        """Branch by branch, the (t0, t0 + TM) of each time tile the kernel computes."""
        return tuple(tuple((t0, min(t0 + tm, T)) for t0 in range(0, T, tm)) for tm in self.tm)


def _launches_of(chain: bool, units: int) -> List[Tuple[int, int]]:
    return [(0, 2 * units)] if chain else [(2 * u, 2 * u + 2) for u in range(units)]


def _cta_clocks(k: int, dils, q0: int, q1: int, TM: int, Kp: int, nw: int, np_: int,
                dtype: torch.dtype) -> float:
    """A rough cost of one CTA in SM clocks: products, epilogues, input tile, fixed."""
    rows, n = branch_rows(k, dils, q0, q1, TM)
    if dtype == torch.bfloat16:  # tensor cores, or shared memory (~80% of its 128 B a clock):
        per_step = max(nw / 2, (16 + nw / 4) / 0.8)  # A 2 KB by ldmatrix, B 32 NW bytes by wgmma
    else:
        per_step = 8 * nw  # FMAs
    mma = sum(n) * k * (Kp / 16) * per_step
    epilogue = sum(n) * 64 * nw * 4 / 128
    load = rows * Kp * 4 / 24 / np_ + (rows * Kp * 2 / 64 if np_ > 1 else 0)
    return mma + epilogue + load + 3000 + 600 * (q1 - q0)


def _makespan(costs: List[Tuple[float, int]]) -> float:
    """Longest-first list scheduling of (cost, count) CTAs on the card's SMs (one CTA each)."""
    if sum(n for _, n in costs) <= SMS:
        return max(c for c, n in costs if n)
    loads = [0.0] * SMS
    for cost, count in sorted(costs, reverse=True):
        for _ in range(count):
            heapq.heapreplace(loads, loads[0] + cost)
    return max(loads)


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, T: int, C: int, kernels: Tuple[int, ...], dils: Tuple[int, ...],
              mxu_dtype: torch.dtype = torch.bfloat16, tile: Optional[int] = None) -> StagePlan:
    """The kernel's plan for a stage of B x T x C.

    Chain mode where C <= 64 (the state and the operand tile of a whole branch
    chain fit one SM), else unit mode with NW from UNIT_NW. For each time tile of
    the heaviest branch (multiples of 64 that fit the SM and the kernel's
    accumulators), every other branch takes one of the largest tiles whose CTA
    costs no more (or 64), so the branches' CTAs cost about the same. Of these
    plans the ones whose CTAs fill the card's 132 SMs come first (where the
    stage can be cut that finely), then the soonest done by a rough cost model
    (`_cta_clocks`, longest-first scheduling on the SMs), then the fewest CTAs.
    ``tile`` fixes every branch's time tile (a multiple of 64 the kernel can
    hold). Raises ValueError for what the kernel does not take.
    """
    kernels, dils = tuple(int(k) for k in kernels), tuple(int(d) for d in dils)
    nb, units = len(kernels), len(dils)
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"the MRF kernel takes 1 to {MAX_NB} branches, got {nb}")
    if not 1 <= units <= MAX_UNITS:
        raise ValueError(f"the MRF kernel takes 1 to {MAX_UNITS} units, got {units}")
    if min(kernels) < 1 or min(dils) < 1:
        raise ValueError(f"kernels {kernels} and dilations {dils} must be >= 1")
    if stage_receptive_field(kernels, dils) > HALO:
        raise ValueError(f"receptive field {stage_receptive_field(kernels, dils)} > {HALO}: "
                         "the MRF kernel takes the JAX kernel's halo at most")
    if B < 1 or T < 1 or C < 1:
        raise ValueError(f"B, T, C must be >= 1, got {B}, {T}, {C}")
    if mxu_dtype not in MXU_DTYPES:
        raise TypeError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")
    if tile is not None and (tile < 64 or tile % 64):
        raise ValueError(f"the MRF kernel's time tile is a multiple of 64, got {tile}")
    Kp = padded_channels(C)
    chain = Kp <= 64
    nws = [Kp] if chain else [w for w in UNIT_NW[mxu_dtype] if Kp % w == 0 and Kp // w <= MAX_NP]
    if not nws:
        raise ValueError(f"the MRF kernel takes C <= {64 * MAX_NP}, got {C}")
    spans = _launches_of(chain, units)
    t_cap = -(-T // 64) * 64
    order = tuple(sorted(range(nb), key=lambda j: -kernels[j]))
    # the most CTAs any plan has: every branch in 64-row tiles, the smallest NW
    fill = min(SMS, nb * B * -(-T // 64) * (Kp // min(nws)))
    best = None
    # a ring of 4 stages or more keeps the tap copies ahead of the products; 2 where
    # nothing else fits
    for min_stages in (4, 2):
        if best is None:
            best = _best_plan(B, T, C, kernels, dils, mxu_dtype, tile, Kp, chain, nws, spans,
                              t_cap, order, fill, min_stages)
    if best is None:
        if tile is not None:
            raise ValueError(f"the MRF kernel cannot hold a time tile of {tile} rows at C={C}, "
                             f"kernels {kernels}, dilations {dils}")
        raise ValueError(f"no time tile of the MRF kernel fits C={C}, kernels {kernels}, "
                         f"dilations {dils}")
    return best[1]


def _best_plan(B, T, C, kernels, dils, mxu_dtype, tile, Kp, chain, nws, spans, t_cap, order,
               fill, min_stages):
    """tile_plan's search over NW and time tiles with rings of `min_stages` or more."""
    nb = len(kernels)
    best = None
    for nw in nws:
        np_ = Kp // nw
        cap = NWG * tiles_a_warpgroup(nw, Kp, mxu_dtype)

        def fits(j, tm):  # rows and tiles a CTA holds, and the smallest ring
            rows = max(branch_rows(kernels[j], dils, q0, q1, tm)[0] for q0, q1 in spans)
            ok = all(max(branch_rows(kernels[j], dils, q0, q1, tm)[1]) <= cap
                     for q0, q1 in spans)
            return ok and smem_bytes(rows, tm, C, nw, mxu_dtype, chain,
                                     min_stages) <= SMEM_LIMIT, rows

        def cost(j, tm):
            return [_cta_clocks(kernels[j], dils, q0, q1, tm, Kp, nw, np_, mxu_dtype)
                    for q0, q1 in spans]

        cands = {j: [tm for tm in range(64, max(t_cap, 64) + 1, 64) if fits(j, tm)[0]]
                 for j in range(nb)}
        if tile is not None:
            if not all(tile in cands[j] for j in range(nb)):
                continue
            choices = [(tile,) * nb]
        elif not all(cands.values()):
            continue
        else:
            heavy = order[0]
            choices = []
            for tm_h in cands[heavy]:
                limit = sum(cost(heavy, tm_h))
                per = [[tm_h] if j == heavy else sorted(
                    {cands[j][0], *[tm for tm in cands[j] if sum(cost(j, tm)) <= limit][-3:]})
                    for j in range(nb)]
                choices.extend(itertools.product(*per))
        for tms in dict.fromkeys(choices):
            rows = max(fits(j, tms[j])[1] for j in range(nb))
            stages = [s for s in range(min_stages, MAX_STAGES + 1)
                      if smem_bytes(rows, max(tms), C, nw, mxu_dtype, chain, s) <= SMEM_LIMIT]
            if not stages:  # the branches fit one by one, not the largest of each together
                continue
            stages = max(stages)
            items = [B * -(-T // tms[j]) for j in range(nb)]
            total = 0.0
            for li, _ in enumerate(spans):
                total += 2000 + _makespan([(cost(j, tms[j])[li], items[j] * np_)
                                           for j in range(nb)])
            ctas = sum(items) * np_
            key = (ctas < fill, total, ctas)
            if best is None or key < best[0]:
                best = (key, StagePlan(
                    chain=chain, nw=nw, np=np_, tm=tms, order=order, stages=stages, rows=rows,
                    smem=smem_bytes(rows, max(tms), C, nw, mxu_dtype, chain, stages),
                    ctas=ctas, kernel_launches=len(spans) + 1))
    return best


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


def _leaky(t: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(t, LRELU_SLOPE)


def mrf_stage_reference(
    xs: Union[torch.Tensor, Sequence[torch.Tensor]],
    weights: MRFStageWeights,
    mxu_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel in the generator's layout.

    xs: one (B, C, T) tensor that every branch starts from, or one per branch.
    Returns the branch mean (B, C, T), fp32.
    """
    nb = len(weights.kernels)
    if isinstance(xs, torch.Tensor):
        xs = [xs] * nb
    acc = None
    for j, k in enumerate(weights.kernels):
        cur = xs[j].float()
        for u, d in enumerate(weights.dils):
            w1, b1 = weights.conv(u, 0, j, cur.device)
            w2, b2 = weights.conv(u, 1, j, cur.device)
            a = F.pad(_round(_leaky(cur), mxu_dtype), (d * (k - 1), 0))
            y = F.conv1d(a, _round(w1, mxu_dtype), b1, dilation=d)
            a = F.pad(_round(_leaky(y), mxu_dtype), (k - 1, 0))
            cur = cur + F.conv1d(a, _round(w2, mxu_dtype), b2)
        acc = cur if acc is None else acc + cur
    return acc * (1.0 / nb)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry `mrf_stage`, built and typed once."""
    fn = _build.load("mrf_stage").mrf_stage
    int_p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 6
        + [int_p, ctypes.c_int, int_p] + [ctypes.c_int] * 6 + [int_p, int_p, ctypes.c_int]
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _c_ints(values: Tuple[int, ...]):
    return (ctypes.c_int * len(values))(*values)


def _mrf_stage_cuda(name, x, weights, tiled, layout, mxu_dtype, B, C, T, plan):
    nb, nu = len(weights.kernels), len(weights.dils)
    w_flat, b_flat = weights.kernel_layout(mxu_dtype, x.device)
    if layout == "btc":
        out = torch.empty((B, T, C), dtype=x.dtype, device=x.device)
        (xb, xt, xc), (ob, ot, oc) = x.stride(), out.stride()
    else:
        out = torch.empty((B, C, T), dtype=x.dtype, device=x.device)
        (xb, xc, xt), (ob, oc, ot) = x.stride(), out.stride()
    xj = C * xc if tiled else 0
    if T == 0 or B == 0:
        return out
    # one scratch buffer: the branches' fp32 states s0 (and s1), (nb, B, C, T) each, and,
    # between unit launches, their leaky(state) in the operand type, a0 (and a1). It may
    # be freed on return while the kernels still run: the caching allocator hands it only
    # to work queued later on this stream
    n = nb * B * C * T
    n_s = 1 if plan.chain or nu == 1 else 2
    n_a = 0 if plan.chain or nu == 1 else min(nu - 1, 2)
    ratio = 2 if mxu_dtype == torch.bfloat16 else 1  # fp32 words an operand element
    pad = -(-n // 64) * 64  # keeps every part 256-byte aligned
    scratch = torch.empty(n_s * pad + -(-n_a * pad // ratio), dtype=torch.float32,
                          device=x.device)
    base = scratch.data_ptr()
    ptr = [base, base + 4 * pad if n_s > 1 else 0]
    a_base = base + 4 * n_s * pad
    a_size = pad * (4 // ratio)
    ptr += [a_base if n_a > 0 else 0, a_base + a_size if n_a > 1 else 0]
    args = (x.data_ptr(), xb, xj, xc, xt, int(x.dtype == torch.bfloat16),
            out.data_ptr(), ob, oc, ot, *ptr, w_flat.data_ptr(), b_flat.data_ptr(),
            _c_ints(weights.kernels), nb, _c_ints(weights.dils), nu, B, C, T,
            int(mxu_dtype == torch.bfloat16), plan.nw, _c_ints(plan.tm), _c_ints(plan.order),
            plan.stages)
    if x.device.index == torch.cuda.current_device():
        err = _entry()(*args, torch.cuda.current_stream(x.device).cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = _entry()(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def _mrf_stage(name, x, packed, channels, kernels, dils, mxu_dtype, layout, tiled, tile=None):
    kernels, dils = tuple(int(k) for k in kernels), tuple(int(d) for d in dils)
    weights = (packed if isinstance(packed, MRFStageWeights)
               else MRFStageWeights.from_packed(packed, kernels, dils))
    if (weights.kernels, weights.dils, weights.channels) != (kernels, dils, channels):
        raise ValueError(
            f"weights are for kernels {weights.kernels}, dilations {weights.dils}, "
            f"{weights.channels} channels; called with {kernels}, {dils}, {channels}"
        )
    if mxu_dtype not in MXU_DTYPES:
        raise TypeError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")
    if layout not in ("btc", "bct"):
        raise ValueError(f"layout must be 'btc' or 'bct', got {layout!r}")
    if x.dtype not in IO_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    nb, C = len(kernels), channels
    width = nb * C if tiled else C
    if x.dim() != 3 or x.shape[2 if layout == "btc" else 1] != width:
        want = "(B, T, {0})" if layout == "btc" else "(B, {0}, T)"
        raise ValueError(f"x must be {want.format(width)}, got {tuple(x.shape)}")
    B, T = x.shape[0], x.shape[1 if layout == "btc" else 2]
    # the kernel's plan: raises where the kernel cannot take the shape or the tile
    plan = tile_plan(max(B, 1), max(T, 1), C, kernels, dils, mxu_dtype, tile)
    if x.is_cuda:
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        return _mrf_stage_cuda(name, x, weights, tiled, layout, mxu_dtype, B, C, T, plan)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    xt = x.transpose(1, 2) if layout == "btc" else x  # (B, width, T)
    xs = [xt[:, j * C:(j + 1) * C] for j in range(nb)] if tiled else xt
    y = mrf_stage_reference(xs, weights, mxu_dtype).to(x.dtype)
    return y.transpose(1, 2).contiguous() if layout == "btc" else y


def mrf_stage_pallas_v2(
    x: torch.Tensor,
    packed,
    *,
    channels: int,
    kernels: Tuple[int, ...] = (3, 7, 11),
    dils: Tuple[int, ...] = (1, 3, 5),
    mxu_dtype: torch.dtype = torch.bfloat16,
    layout: str = "btc",
    tile: Optional[int] = None,
) -> torch.Tensor:
    """K3a: (B, T, C) -> (B, T, C), every branch starting from x (layout="bct": (B, C, T)).

    ``tile``, as in the JAX function, asks for the kernel's time tile (every
    branch's); ValueError where the kernel cannot hold it. The result does not
    depend on it, and the CPU's plain version has none.
    """
    return _mrf_stage("mrf_stage_pallas_v2", x, packed, channels, kernels, dils, mxu_dtype,
                      layout, tiled=False, tile=tile)


def mrf_stage_pallas(
    x: torch.Tensor,
    packed,
    *,
    channels: int,
    kernels: Tuple[int, ...] = (3, 7, 11),
    dils: Tuple[int, ...] = (1, 3, 5),
    mxu_dtype: torch.dtype = torch.bfloat16,
    layout: str = "btc",
) -> torch.Tensor:
    """K3b: branch-tiled (B, T, nb*C) -> branch mean (B, T, C).

    layout="bct": (B, nb*C, T) -> (B, C, T).
    """
    return _mrf_stage("mrf_stage_pallas", x, packed, channels, kernels, dils, mxu_dtype,
                      layout, tiled=True)
