"""Gated best/second-best Hamming search: a Triton kernel and its XLA
reference, behind one dispatch function.

Every projection- or epipolar-guided search of tracking and local
mapping asks the same question: for each source descriptor row, which
candidate column that passes a geometric gate is nearest in Hamming
distance, and how far is the second-nearest (for the ratio test)?

* ``best2_reference`` (XLA) materialises the (M, N) int32 distance
  matrix and the (M, N) gate, then takes ``lax.top_k(-d, 2)``.  On the
  GPU the top-k does not fuse with its producer, so the matrix makes a
  round trip through device memory.
* ``best2_pallas`` (Pallas, Triton route) runs one program per
  (pair, block of source rows): the row descriptors and attributes sit
  in registers, a ``fori_loop`` walks the column tiles, and XOR +
  popcount, the gate and a running best/second/argmin stay on chip.
  Only the (M,) results are written.

``best2`` picks the kernel on the GPU and the reference elsewhere; it is
the one place in the package that chooses between a kernel and XLA.

Attributes are 8 float32 lanes per row (layouts below).  Four gate
modes share one gate function, so kernel and reference evaluate the
same formulas:

* ``"window"``: projection window ``|du|, |dv| <= r_narrow``, octave in
  [oct_lo, oct_hi] (orbMatcher.cpp:24-64); ``check_ur`` adds the stereo
  right-x coherence of orbMatcher.cpp:101-110.
* ``"window2"``: the same at both radii from one XOR+popcount pass (the
  motion matcher's narrow/wide retry, tracking.cpp:450-460).
* ``"fuse"``: the window at r_narrow plus the fuse chi2 gate
  (orbMatcher.cpp:682-745).
* ``"epi"``: point-to-epipolar-line distance ``num^2 < thr *
  sigma2(oct_b)`` with ``|oct_a - oct_b| <= 1`` (orbMatcher.cpp:463-565,
  808-819).

Ties: the smallest column index wins, as in ``lax.top_k``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .hamming import INVALID_DIST, masked_distance_matrix

# Row-side lanes ("window", "window2", "fuse"):
#   [u, v, ur_pred, r_narrow, r_wide, oct_lo, oct_hi, valid]
A_U, A_V, A_UR, A_RN, A_RW, A_OLO, A_OHI, A_VALID = range(8)
# Column-side lanes: [u, v, right_u, octave, valid, inv_sf2, 0, 0]
# (inv_sf2 = 1/scale_factor^(2*octave), read by "fuse" only).
B_U, B_V, B_UR, B_OCT, B_VALID, B_ISF2 = range(6)
# "epi" row-side lanes: [line_a, line_b, line_c, thr, octave, valid, 0, 0];
# its column side reuses B_U, B_V, B_OCT, B_VALID with sigma^2(octave) in
# lane B_UR.
E_LA, E_LB, E_LC, E_THR, E_OCT, E_VALID = range(6)
B_SIG2 = B_UR

MODES = ("window", "window2", "fuse", "epi")

# Block sizes of the Triton kernel: powers of two, the fastest of a
# sweep over all four modes at tracking and mapping widths on an H100
# (PERF.md, PR 1).  Small blocks keep the (BLOCK_M, BLOCK_N) tile in
# registers and give the grid enough programs to fill the card.
BLOCK_M = 16
BLOCK_N = 64
NUM_WARPS = 2


def n_outputs(mode: str) -> int:
    return 2 if mode == "window2" else 1


def gates(mode: str, check_ur: bool, a, b):
    """Gate masks from attribute lanes.  ``a[k]`` broadcasts along the
    column axis and ``b[k]`` along the row axis.  Returns one mask per
    output (two for "window2")."""
    if mode == "epi":
        num = a[E_LA] * b[B_U] + a[E_LB] * b[B_V] + a[E_LC]
        return [
            (a[E_VALID] > 0.5) & (b[B_VALID] > 0.5)
            & (jnp.abs(b[B_OCT] - a[E_OCT]) <= 1.0)
            & (num * num < a[E_THR] * b[B_SIG2])
        ]
    du = b[B_U] - a[A_U]
    dv = b[B_V] - a[A_V]
    adu, adv = jnp.abs(du), jnp.abs(dv)
    base = (
        (a[A_VALID] > 0.5) & (b[B_VALID] > 0.5)
        & (b[B_OCT] >= a[A_OLO]) & (b[B_OCT] <= a[A_OHI])
    )
    dur = b[B_UR] - a[A_UR]
    no_r = b[B_UR] < 0.0

    def window(r):
        w = (adu <= r) & (adv <= r)
        if check_ur:
            w = w & (no_r | (jnp.abs(dur) <= r))
        return base & w

    if mode == "window":
        return [window(a[A_RN])]
    if mode == "window2":
        return [window(a[A_RN]), window(a[A_RW])]
    # "fuse": stereo keypoints face (du^2+dv^2+dur^2)*inv_sf2 <= 7.81,
    # mono ones (du^2+dv^2)*inv_sf2 <= 5.99 (orbMatcher.cpp:714-721).
    mono2 = du * du + dv * dv
    isf2 = b[B_ISF2]
    chi2_ok = ((~no_r) & ((mono2 + dur * dur) * isf2 <= 7.81)) | (
        no_r & (mono2 * isf2 <= 5.99)
    )
    return [window(a[A_RN]) & chi2_ok]


def _check(desc_a, attr_a, desc_b, attr_b, mode):
    if mode not in MODES:
        raise ValueError(f"unknown gate mode {mode!r}")
    Bp, M = desc_a.shape[:2]
    N = desc_b.shape[1]
    if (desc_a.shape != (Bp, M, 8) or attr_a.shape != (Bp, M, 8)
            or desc_b.shape != (Bp, N, 8) or attr_b.shape != (Bp, N, 8)):
        raise ValueError(
            "expected (B, M, 8) / (B, N, 8) descriptors and attributes, got "
            f"{desc_a.shape} {attr_a.shape} {desc_b.shape} {attr_b.shape}"
        )


@functools.partial(jax.jit, static_argnames=("mode", "check_ur"))
def best2_reference(desc_a, attr_a, desc_b, attr_b, mode: str,
                    check_ur: bool = False):
    """Dense XLA formulation.  desc (B, ·, 8) uint32, attr (B, ·, 8)
    float32.  Returns a tuple of ``n_outputs(mode)`` triples
    (idx, best, second), each (B, M) int32; idx = -1 and best = second =
    INVALID_DIST where a row has no gated candidate."""
    _check(desc_a, attr_a, desc_b, attr_b, mode)
    a = [attr_a[:, :, k, None] for k in range(8)]
    b = [attr_b[:, None, :, k] for k in range(8)]
    masks = gates(mode, check_ur, a, b)

    def one(da, db, mask):
        d = masked_distance_matrix(
            da, db, jnp.ones(da.shape[0], bool), jnp.ones(db.shape[0], bool),
            mask,
        )
        vals, idxs = jax.lax.top_k(-d, 2)
        b1, b2 = -vals[:, 0], -vals[:, 1]
        return jnp.where(b1 < INVALID_DIST, idxs[:, 0], -1), b1, b2

    return tuple(jax.vmap(one)(desc_a, desc_b, m) for m in masks)


def _best2_kernel(a_desc_ref, a_attr_ref, b_desc_ref, b_attr_ref, *out_refs,
                  mode, check_ur, n_tiles):
    block_m, block_n = BLOCK_M, BLOCK_N
    p = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * block_m, block_m)
    a_words = [a_desc_ref[p, w, rows][:, None] for w in range(8)]
    a = [a_attr_ref[p, k, rows][:, None] for k in range(8)]
    n_out = n_outputs(mode)
    big = jnp.full((block_m,), INVALID_DIST, jnp.int32)
    init = (big, big, jnp.full((block_m,), -1, jnp.int32)) * n_out
    col = jax.lax.broadcasted_iota(jnp.int32, (block_m, block_n), 1)

    def tile(j, carry):
        start = pl.multiple_of(j * block_n, block_n)
        cols = pl.ds(start, block_n)
        b = [b_attr_ref[p, k, cols][None, :] for k in range(8)]
        d = jnp.zeros((block_m, block_n), jnp.int32)
        for w in range(8):
            x = a_words[w] ^ b_desc_ref[p, w, cols][None, :]
            d = d + jax.lax.population_count(x)
        out = []
        for g, mask in enumerate(gates(mode, check_ur, a, b)):
            best, second, idx = carry[3 * g:3 * g + 3]
            dg = jnp.where(mask, d, INVALID_DIST)
            arg = jnp.argmin(dg, axis=1).astype(jnp.int32)
            t_min = jnp.min(dg, axis=1)
            t_second = jnp.min(
                jnp.where(col == arg[:, None], INVALID_DIST, dg), axis=1
            )
            better = t_min < best
            out += [
                jnp.minimum(best, t_min),
                jnp.minimum(
                    jnp.minimum(second, t_second),
                    jnp.where(better, best, t_min),
                ),
                jnp.where(better, arg + start, idx),
            ]
        return tuple(out)

    res = jax.lax.fori_loop(0, n_tiles, tile, init)
    for g in range(n_out):
        best, second, idx = res[3 * g:3 * g + 3]
        out_refs[3 * g][p, rows] = idx
        out_refs[3 * g + 1][p, rows] = best
        out_refs[3 * g + 2][p, rows] = second


def _pad_to(x, axis, mult):
    n = x.shape[axis]
    pad = -n % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


@functools.partial(
    jax.jit, static_argnames=("mode", "check_ur", "interpret")
)
def best2_pallas(desc_a, attr_a, desc_b, attr_b, mode: str,
                 check_ur: bool = False, interpret: bool = False):
    """Triton kernel; same contract as ``best2_reference``.

    Rows and columns are zero-padded to the block sizes (a zero valid
    lane gates the padding out).  Descriptors and attributes are handed
    to the kernel lane-major, (B, 8, ·), so every load is contiguous,
    and the uint32 descriptor words are bitcast to int32 because
    Triton's popcount lowers for int32 and int64 only."""
    _check(desc_a, attr_a, desc_b, attr_b, mode)
    Bp, M = desc_a.shape[:2]

    def lanes(x, mult):
        return jnp.swapaxes(_pad_to(x, 1, mult), 1, 2)

    da = lanes(jax.lax.bitcast_convert_type(desc_a, jnp.int32), BLOCK_M)
    aa = lanes(attr_a.astype(jnp.float32), BLOCK_M)
    db = lanes(jax.lax.bitcast_convert_type(desc_b, jnp.int32), BLOCK_N)
    ab = lanes(attr_b.astype(jnp.float32), BLOCK_N)
    Mp, Np = da.shape[2], db.shape[2]
    n_out = n_outputs(mode)
    out = pl.pallas_call(
        functools.partial(
            _best2_kernel, mode=mode, check_ur=check_ur,
            n_tiles=Np // BLOCK_N,
        ),
        out_shape=tuple(
            jax.ShapeDtypeStruct((Bp, Mp), jnp.int32)
            for _ in range(3 * n_out)
        ),
        grid=(Bp, Mp // BLOCK_M),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"best2_{mode}",
    )(da, aa, db, ab)
    return tuple(
        tuple(o[:, :M] for o in out[3 * g:3 * g + 3]) for g in range(n_out)
    )


def use_kernel() -> bool:
    """The Triton kernel on the GPU, the XLA reference elsewhere."""
    return jax.default_backend() == "gpu"


def best2(desc_a, attr_a, desc_b, attr_b, mode: str, check_ur: bool = False):
    """Gated best/second search over B (row set, column set) pairs; see
    ``best2_reference`` for the contract."""
    if use_kernel():
        return best2_pallas(desc_a, attr_a, desc_b, attr_b, mode, check_ur)
    return best2_reference(desc_a, attr_a, desc_b, attr_b, mode, check_ur)
