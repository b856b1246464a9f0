"""Pallas (Triton route) GPU kernel for batched Myers edit distance.

The XLA pair kernel (``levenshtein_myers._myers_batch``) is a
``fori_loop`` over text characters whose (B, W) ``VP``/``VN`` state and
gathered Eq bitplanes go back through device memory on every step.
This kernel keeps the whole recurrence on chip:

* one pair per lane, ``TILE`` pairs per program;
* W (the pattern width in 32-bit words) is static, and ``VP``/``VN``
  are W register vectors of shape (TILE,);
* the pattern's bitplanes (``build_planes``: 2K words per word) are
  loaded into registers once, and Eq for text character c is K selects
  per word;
* the multi-word addition ``(Eq & VP) + VP`` and the one-bit shifts
  ripple their carries word by word inside one sweep, so a text
  character costs one pass over the W words;
* the text loop runs inside the kernel and only the distance is
  written out.

Offsets are computed in int32, so the wrapper only accepts tables
below 2**31 elements.

``interpret=True`` runs the same kernel through the Pallas interpreter
(how the CPU tests reach it); it is never chosen implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

UINT1 = np.uint32(1)
UFULL = np.uint32(0xFFFFFFFF)

TILE = 128  # pairs per program: one pair per thread at NUM_WARPS = 4
NUM_WARPS = 4
MAX_TABLE_ELEMS = 2**31 - 1

# Where the engine uses this kernel on a GPU.  Measured on H100s
# (ACGT, K = 2, 65,536 pairs): 15-19x the XLA tier at W = 15-20 and
# faster end to end; at W = 61-100 10-14x per call, but 27-150 s to
# compile per width and not timed end to end, so W > MAX_W stays on
# XLA.  The bitplanes take 2KW registers per lane: past
# PLANES_MAX_WORDS of them (large alphabets) XLA keeps the batch.
MAX_W = 32
PLANES_MAX_WORDS = 128


def serves(K: int, W: int) -> bool:
    """Whether the engine sends W-word patterns over a 2**K-symbol
    alphabet to this kernel on a GPU."""
    return W <= MAX_W and 2 * K * W <= PLANES_MAX_WORDS


def _kernel(pat_ref, txt_ref, la_ref, lb_ref, planes_ref, ids_ref, out_ref,
            *, W: int, K: int, n: int, L: int):
    pat = pat_ref[...]
    txt = txt_ref[...]
    la = la_ref[...]
    lb = lb_ref[...]

    # VP starts with the first `la` bits set; bit b of word w is
    # pattern position 32w + b
    VP, VN = [], []
    zero = jnp.zeros_like(pat).astype(jnp.uint32)
    for w in range(W):
        nbits = jnp.clip(la - 32 * w, 0, 32)
        part = (UINT1 << jnp.minimum(nbits, 31).astype(jnp.uint32)) - UINT1
        VP.append(jnp.where(nbits >= 32, UFULL, part).astype(jnp.uint32))
        VN.append(zero)

    # score tap: bit (la-1) of word (la-1) >> 5
    m1 = jnp.maximum(la - 1, 0)
    tap_word = m1 >> 5
    tap_bit = UINT1 << (m1 & 31).astype(jnp.uint32)

    # planes[k][b][w]: word w of the pattern's plane (k, b)
    planes = [
        [
            [planes_ref[((k * 2 + b) * n + pat) * W + w] for w in range(W)]
            for b in range(2)
        ]
        for k in range(K)
    ]

    def step(j, carry):
        VP, VN, score, result = carry
        c = ids_ref[txt * L + j]
        valid = c >= 0
        bits = [((jnp.maximum(c, 0) >> k) & 1) == 1 for k in range(K)]
        cin = zero  # carry into the current word of (Eq & VP) + VP
        hp_in = zero + UINT1  # HP << 1 shifts a 1 into bit 0
        hn_in = zero
        hp_hit = zero
        hn_hit = zero
        VP2, VN2 = [], []
        for w in range(W):
            eq = None
            for k in range(K):
                sel = jnp.where(bits[k], planes[k][1][w], planes[k][0][w])
                eq = sel if eq is None else (eq & sel)
            eq = jnp.where(valid, eq, zero)
            vp, vn = VP[w], VN[w]
            x = eq & vp
            s = x + vp + cin
            # carry out of bit 31: majority of (x, vp, carry into bit 31)
            cin = ((x & vp) | ((x | vp) & ~s)) >> 31
            d0 = (s ^ vp) | eq | vn
            hp = vn | ~(d0 | vp)
            hn = vp & d0
            on_tap = tap_word == w
            hp_hit = hp_hit | jnp.where(on_tap, hp & tap_bit, zero)
            hn_hit = hn_hit | jnp.where(on_tap, hn & tap_bit, zero)
            x_sh = (hp << 1) | hp_in
            hn_sh = (hn << 1) | hn_in
            hp_in = hp >> 31
            hn_in = hn >> 31
            VP2.append(hn_sh | ~(d0 | x_sh))
            VN2.append(x_sh & d0)
        inc = (hp_hit != 0).astype(jnp.int32) - (hn_hit != 0).astype(jnp.int32)
        live = la > 0
        score = score + jnp.where((j < lb) & live, inc, 0)
        result = jnp.where((j == lb - 1) & live, score, result)
        return VP2, VN2, score, result

    result0 = jnp.where(la == 0, lb, 0)
    _, _, _, result = jax.lax.fori_loop(
        0, jnp.max(lb), step, (VP, VN, la, result0)
    )
    out_ref[...] = result


@functools.partial(jax.jit, static_argnames=("interpret",))
def triton_pairs(planes_tab, ids_tab, P, T, la, lb, interpret: bool = False):
    """Edit distances for pre-swapped pairs (pattern P shorter).

    planes_tab: uint32 (K, 2, n, W) bitplanes (``build_planes``); the
                word axis may be sliced to the batch's widest pattern.
    ids_tab: int32 (n, L) dense alphabet ids (pad -1).
    P, T: int32 (B,) pattern / text rows; la <= lb their lengths.
    Returns int32 (B,).
    """
    K, _, n, W = planes_tab.shape
    if planes_tab.size > MAX_TABLE_ELEMS or ids_tab.size > MAX_TABLE_ELEMS:
        raise ValueError("Myers tables exceed int32 offsets")
    L = ids_tab.shape[1]
    B = P.shape[0]
    pad = (-B) % TILE
    args = [
        jnp.pad(a.astype(jnp.int32), (0, pad)) for a in (P, T, la, lb)
    ]
    pair_spec = pl.BlockSpec((TILE,), lambda i: (i,))
    whole = pl.no_block_spec  # tables stay whole; lanes gather from them
    out = pl.pallas_call(
        functools.partial(_kernel, W=W, K=K, n=n, L=L),
        out_shape=jax.ShapeDtypeStruct((B + pad,), jnp.int32),
        grid=((B + pad) // TILE,),
        in_specs=[pair_spec] * 4 + [whole, whole],
        out_specs=pair_spec,
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="myers_pairs_triton",
    )(*args, planes_tab.reshape(-1), ids_tab.reshape(-1).astype(jnp.int32))
    return out[:B]
