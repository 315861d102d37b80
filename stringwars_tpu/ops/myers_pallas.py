"""Bit-parallel Myers Levenshtein as a Pallas kernel for the GPU (Triton).

The anti-diagonal wavefront (``ops/similarity.py``) updates one DP cell per
lane and keeps its diagonals in device memory between steps. The
Myers/Hyyrö block algorithm packs 32 DP rows of one pair into a u32 word
and advances a whole DP column with ~17 word operations per word (G.
Myers, JACM 1999; block form: Hyyrö 2003 — the formulation Edlib and
StringZilla use on CPU words; reference semantics:
``szs::LevenshteinDistances``, ``similarities/bench.rs:330-347``).

Kernel shape (Pallas, ``backend="triton"``): one program owns a block of
``BLOCK`` pairs, one pair per thread. The text-column loop runs inside the
kernel; the vertical-delta words VP/VN of every pattern word and the
running score stay in registers for the whole loop, and the carry chain
across pattern words is unrolled per word. Each column loads the text
code of every pair and gathers its pattern-match masks ``Peq[code][w]``
(a few KB per block, cache-resident).

Staging compresses the batch alphabet to dense codes, so ``Peq`` holds
one row per symbol that occurs (4 for DNA). Pattern bits past a pair's
length are zero in every row, so padding never matches.

Score tracking: D[m][j] advances by the horizontal delta at row m = bit
(m-1)%32 of the unshifted Ph/Mh of word (m-1)//32, for columns j < |b|.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 32  # pairs per program: one warp, one pair per thread


def _make_kernel(n_words: int, sigma: int, n_cols: int, last_word: int):
    def kernel(peq_ref, text_ref, alen_ref, blen_ref, out_ref):
        blk = pl.program_id(0)
        lane = jnp.arange(BLOCK, dtype=jnp.int32)
        alen = alen_ref[blk * BLOCK + lane]
        blen = blen_ref[blk * BLOCK + lane]
        last = jnp.maximum(alen - 1, 0)
        lastw = last >> 5
        lastr = (last & 31).astype(jnp.uint32)
        one = jnp.uint32(1)
        peq_base = blk * (sigma * n_words * BLOCK) + lane
        text_base = blk * (n_cols * BLOCK) + lane

        def column(j, carry):
            vp, vn, score = carry
            code = text_ref[text_base + j * BLOCK]
            row = peq_base + code * (n_words * BLOCK)
            hp_in = jnp.full((BLOCK,), one)
            hn_in = jnp.zeros((BLOCK,), jnp.uint32)
            sel_ph = jnp.zeros((BLOCK,), jnp.uint32)
            sel_mh = jnp.zeros((BLOCK,), jnp.uint32)
            new_vp, new_vn = [], []
            for w in range(n_words):
                eq = peq_ref[row + w * BLOCK]
                xv = eq | vn[w]
                eq2 = eq | hn_in
                xh = (((eq2 & vp[w]) + vp[w]) ^ vp[w]) | eq2
                ph = vn[w] | ~(xh | vp[w])
                mh = vp[w] & xh
                if last_word < 0:
                    sel_ph = jnp.where(lastw == w, ph, sel_ph)
                    sel_mh = jnp.where(lastw == w, mh, sel_mh)
                elif w == last_word:
                    sel_ph, sel_mh = ph, mh
                phs = (ph << 1) | hp_in
                mhs = (mh << 1) | hn_in
                new_vp.append(mhs | ~(xv | phs))
                new_vn.append(phs & xv)
                hp_in = ph >> 31
                hn_in = mh >> 31
            delta = ((sel_ph >> lastr) & one).astype(jnp.int32) - (
                (sel_mh >> lastr) & one
            ).astype(jnp.int32)
            score = score + jnp.where(j < blen, delta, 0)
            return tuple(new_vp), tuple(new_vn), score

        vp0 = tuple(jnp.full((BLOCK,), 0xFFFFFFFF, jnp.uint32) for _ in range(n_words))
        vn0 = tuple(jnp.zeros((BLOCK,), jnp.uint32) for _ in range(n_words))
        _, _, score = jax.lax.fori_loop(0, n_cols, column, (vp0, vn0, alen))
        # An empty pattern never updates the score; its distance is |b|.
        out_ref[blk * BLOCK + lane] = jnp.where(alen == 0, blen, score)

    return kernel


@functools.partial(
    jax.jit, static_argnames=("n_words", "sigma", "last_word", "interpret")
)
def _myers(peq, text, alen, blen, *, n_words: int, sigma: int, last_word: int = -1,
           interpret: bool = False):
    """Distances of staged blocks: ``peq`` u32[n_blk, sigma*n_words*BLOCK],
    ``text`` i32[n_blk, n_cols*BLOCK], ``alen``/``blen`` i32[n_blk, BLOCK]
    -> i32[n_blk, BLOCK]. Leading axes are blocks, so ``shard_map`` can
    split a batch across devices."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Myers kernel compiles only for a GPU; pass interpret=True "
            f"to emulate it on {jax.default_backend()!r}"
        )
    n_blk = peq.shape[0]
    n_cols = text.shape[1] // BLOCK
    out = pl.pallas_call(
        _make_kernel(n_words, sigma, n_cols, last_word),
        out_shape=jax.ShapeDtypeStruct((n_blk * BLOCK,), jnp.int32),
        grid=(n_blk,),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        name="myers_levenshtein",
    )(peq.reshape(-1), text.reshape(-1), alen.reshape(-1), blen.reshape(-1))
    return out.reshape(n_blk, BLOCK)


class MyersBatch:
    """Pairs staged for the Myers kernel: dense symbol codes, per-pair
    pattern-match masks and text columns, laid out block-major."""

    def __init__(self, a: np.ndarray, b: np.ndarray, a_len: np.ndarray, b_len: np.ndarray):
        B, A = a.shape
        L = max(int(b.shape[1]), 1)
        a_len = np.asarray(a_len, np.int64)
        b_len = np.asarray(b_len, np.int64)
        in_a = np.arange(A)[None, :] < a_len[:, None]
        in_b = np.arange(b.shape[1])[None, :] < b_len[:, None]
        alphabet, codes = np.unique(
            np.concatenate([a[in_a], b[in_b], [0]]), return_inverse=True
        )
        code_a = np.zeros(a.shape, np.int64)
        code_b = np.zeros(b.shape, np.int64)
        code_a[in_a] = codes[: int(in_a.sum())]
        code_b[in_b] = codes[int(in_a.sum()) : int(in_a.sum()) + int(in_b.sum())]
        sigma = int(alphabet.shape[0])
        W = max(1, -(-A // 32))
        n_blk = max(1, -(-B // BLOCK))
        Bp = n_blk * BLOCK

        # Peq[p, code, w] |= 1 << (i % 32) for every pattern position i.
        p_idx, i_idx = np.nonzero(in_a)
        flat = (p_idx * sigma + code_a[p_idx, i_idx]) * W + i_idx // 32
        bits = np.left_shift(1, i_idx % 32).astype(np.float64)
        peq = np.bincount(flat, weights=bits, minlength=Bp * sigma * W)
        peq = peq.astype(np.uint64).astype(np.uint32).reshape(n_blk, BLOCK, sigma, W)
        self.peq = jnp.asarray(peq.transpose(0, 2, 3, 1).reshape(n_blk, -1))

        text = np.zeros((Bp, L), np.int32)
        text[:B, : b.shape[1]] = code_b
        self.text = jnp.asarray(text.reshape(n_blk, BLOCK, L).transpose(0, 2, 1).reshape(n_blk, -1))

        def per_block(v):
            out = np.zeros(Bp, np.int32)
            out[:B] = v
            return jnp.asarray(out.reshape(n_blk, BLOCK))

        self.alen = per_block(a_len)
        self.blen = per_block(b_len)
        self.count = B
        self.n_words = W
        self.sigma = sigma
        lastw = np.where(a_len > 0, (a_len - 1) // 32, -1)
        # Static specialization: every pattern ends in one word, so the
        # kernel reads the score bit from that word alone.
        self.last_word = int(lastw[0]) if (B and lastw.min() == lastw.max() >= 0) else -1
        self._np_alen = a_len
        self._np_blen = b_len

    def arrays(self) -> tuple[jax.Array, ...]:
        return self.peq, self.text, self.alen, self.blen

    def statics(self) -> dict:
        return {"n_words": self.n_words, "sigma": self.sigma, "last_word": self.last_word}

    def cells(self) -> int:
        return int((self._np_alen * self._np_blen).sum())


def myers_distances(batch: MyersBatch, *, interpret: bool = False) -> np.ndarray:
    """Levenshtein distance per pair -> int64[count]."""
    out = _myers(*batch.arrays(), **batch.statics(), interpret=interpret)
    return np.asarray(out).reshape(-1)[: batch.count].astype(np.int64)


def _pack(a_seqs, b_seqs) -> MyersBatch:
    B = len(a_seqs)
    A = max((len(t) for t in a_seqs), default=1)
    L = max((len(t) for t in b_seqs), default=1)
    a = np.zeros((B, max(A, 1)), np.int64)
    b = np.zeros((B, max(L, 1)), np.int64)
    a_len = np.zeros(B, np.int64)
    b_len = np.zeros(B, np.int64)
    for i, (x, y) in enumerate(zip(a_seqs, b_seqs)):
        a[i, : len(x)] = x
        b[i, : len(y)] = y
        a_len[i], b_len[i] = len(x), len(y)
    return MyersBatch(a, b, a_len, b_len)


def myers_from_tokens(a_tokens: list[bytes], b_tokens: list[bytes]) -> MyersBatch:
    """Byte-level staging from token lists."""
    return _pack(
        [np.frombuffer(t, np.uint8) for t in a_tokens],
        [np.frombuffer(t, np.uint8) for t in b_tokens],
    )


def myers_from_codepoints(a_cps: list[np.ndarray], b_cps: list[np.ndarray]) -> MyersBatch:
    """Codepoint-level staging (the LevenshteinDistancesUtf8 analog,
    ``similarities/bench.rs:230-247``; CUPS count codepoint cells)."""
    return _pack(a_cps, b_cps)
