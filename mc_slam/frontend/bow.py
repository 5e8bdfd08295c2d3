"""Place recognition: binary bag-of-words as integer GEMMs.

Batched replacement for DBoW2 (Thirdparty/DBoW2: TemplatedVocabulary
k-ary tree transform + inverted-index scoring + KeyFrameDatabase retrieval,
src/KeyFrameDatabase.cpp). The CPU design (1M-node vocabulary tree walked
per descriptor + inverted file) becomes:

  * a FLAT vocabulary of W binary centroids; descriptor->word assignment is
    one int8 matmul (N,256)@(256,W) + argmax — the tree exists only to make
    CPU lookup O(log W), which a GEMM doesn't need;
  * per-keyframe tf-idf-normalized word histograms (the BowVector);
  * retrieval = one (K, W) @ (W,) matmul against every keyframe's histogram
    (the inverted file is again a CPU sparsity trick).

The vocabulary is trained on-the-fly with k-majority iterations over observed
descriptors (train_vocab), or seeded randomly (random_vocab) — recall parity
is asserted in tests by loop-closure detection on revisited synthetic scenes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_WORDS = 2048

_ASSET = __import__("os").path.join(__import__("os").path.dirname(__file__),
                                    "..", "assets", "vocab.npz")


def load_default_vocab(key=None):
    """The shipped trained vocabulary (mc_slam/assets/vocab.npz, trained by
    examples/train_vocab.py — the ORBvoc artifact's role); falls back to a
    random vocabulary when the asset is absent."""
    import os
    import numpy as np
    if os.path.exists(_ASSET):
        z = np.load(_ASSET)
        bits = np.unpackbits(z["bits"], axis=1)[:, :256]
        v = jnp.asarray(bits.astype(np.int8) * 2 - 1)
        # complete the (multi-MB) upload before anything else talks to the
        # device
        jax.block_until_ready(v)
        return v
    if key is None:
        key = jax.random.PRNGKey(0)
    return random_vocab(key)


def load_default_idf():
    """(W,) float32 inverse-document-frequency weights shipped with the
    vocabulary (DBoW2's tf-idf weighting, TemplatedVocabulary
    createWords/setNodeWeights): words common to every rendered view carry
    ~no place information and must not dominate the histogram dot product.
    None when the asset predates idf training."""
    import os
    import numpy as np
    if os.path.exists(_ASSET):
        z = np.load(_ASSET)
        if "idf" in z:
            v = jnp.asarray(z["idf"].astype(np.float32))
            jax.block_until_ready(v)
            return v
    return None


def compute_idf(desc_pm1, valid, vocab, doc_id, n_docs, soft_k: int = 4,
                batch: int = 4096):
    """idf from a training corpus: log(N / (1 + df_w)) with df_w = number of
    documents (frames) whose descriptors vote for word w (same soft top-k
    assignment as bow_histogram). doc_id: (N,) int32 frame index per
    descriptor. Chunked like train_vocab — the dense (N, W) distance matrix
    at corpus scale would be tens of GB."""
    import numpy as np
    N = desc_pm1.shape[0]
    Npad = int(np.ceil(N / batch)) * batch
    d = jnp.zeros((Npad, 256), jnp.int8).at[:N].set(desc_pm1.astype(jnp.int8))
    v = jnp.zeros((Npad,), jnp.float32).at[:N].set(valid.astype(jnp.float32))
    doc = jnp.zeros((Npad,), jnp.int32).at[:N].set(doc_id.astype(jnp.int32))

    @jax.jit
    def run(d, v, doc):
        def body(seen, chunk):
            d_c, v_c, doc_c = chunk
            dot = jax.lax.dot_general(d_c, vocab, (((1,), (1,)), ((), ())),
                                      preferred_element_type=jnp.int32)
            _, topi = jax.lax.top_k(dot, soft_k)
            docs = jnp.broadcast_to(doc_c[:, None], topi.shape)
            seen = seen.at[docs, topi].max(
                jnp.broadcast_to(v_c[:, None], topi.shape).astype(jnp.float32))
            return seen, None

        seen0 = jnp.zeros((n_docs, vocab.shape[0]), jnp.float32)
        seen, _ = jax.lax.scan(
            body, seen0, (d.reshape(-1, batch, 256),
                          v.reshape(-1, batch), doc.reshape(-1, batch)))
        return jnp.log(float(n_docs) / (1.0 + seen.sum(axis=0)))

    return run(d, v, doc)


def random_vocab(key, n_words=DEFAULT_WORDS):
    """(W, 256) int8 +/-1 random binary centroids."""
    bits = jax.random.bernoulli(key, 0.5, (n_words, 256))
    return (bits.astype(jnp.int8) * 2 - 1)


def train_vocab(desc_pm1, valid, key, n_words=DEFAULT_WORDS, iters=4,
                batch=4096):
    """k-majority clustering of +/-1 descriptors (binary k-means).

    desc_pm1: (N, 256) int8; valid: (N,). Empty clusters re-seed randomly.
    Assignment runs in `batch`-row chunks under a lax.scan so vocabularies at
    ORBvoc-like scale (32k+ words over 10^5-10^6 descriptors) fit HBM: the
    dense (N, W) distance matrix of the naive form would be tens of GB.
    """
    import numpy as np
    N = desc_pm1.shape[0]
    key, sub = jax.random.split(key)
    init_idx = jax.random.choice(sub, N, (n_words,), replace=True,
                                 p=valid / jnp.maximum(valid.sum(), 1.0))
    vocab = desc_pm1[init_idx]
    Npad = int(np.ceil(N / batch)) * batch
    d = jnp.zeros((Npad, 256), jnp.int8).at[:N].set(desc_pm1.astype(jnp.int8))
    v = jnp.zeros((Npad,), jnp.float32).at[:N].set(valid.astype(jnp.float32))
    d_r = d.reshape(-1, batch, 256)
    v_r = v.reshape(-1, batch)

    @jax.jit
    def step(vocab, key):
        def body(carry, chunk):
            sums, counts = carry
            d_c, v_c = chunk
            dot = jax.lax.dot_general(d_c, vocab, (((1,), (1,)), ((), ())),
                                      preferred_element_type=jnp.int32)
            assign = jnp.argmax(dot, axis=1)
            sums = sums.at[assign].add(
                d_c.astype(jnp.float32) * v_c[:, None])
            counts = counts.at[assign].add(v_c)
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            body,
            (jnp.zeros((n_words, 256), jnp.float32),
             jnp.zeros((n_words,), jnp.float32)),
            (d_r, v_r))
        maj = jnp.where(sums >= 0, 1, -1).astype(jnp.int8)
        rnd = random_vocab(key, n_words)
        return jnp.where((counts > 0)[:, None], maj, rnd)

    for _ in range(iters):
        key, sub = jax.random.split(key)
        vocab = step(vocab, sub)
    return vocab


@partial(jax.jit, static_argnames=("soft_k",))
def bow_histogram(desc_pm1, valid, vocab, soft_k: int = 4, idf=None):
    """tf histogram over vocabulary words, L2-normalized. (N,256),(N,),(W,256)
    -> (W,) float32. (The reference scores L1 on tf-idf; L2-dot scoring is the
    same ordering family and one matmul — idf folded in by score_all's caller
    if desired.)

    soft_k > 1: each descriptor votes for its top-k words, weighted by
    similarity relative to the best. At ORBvoc-like vocabulary scale (32k+
    words) hard assignment over-specializes — the same physical patch lands
    in different fine words across viewpoints and held-out revisit recall
    collapses (measured 0.67 hard vs 1.00 soft-4 at 32768 words); DBoW2
    compensates with hierarchical scoring + direct indexes, soft assignment
    is the flat-vocabulary equivalent and stays two GEMMs."""
    dot = jax.lax.dot_general(desc_pm1, vocab, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    if soft_k <= 1:
        assign = jnp.argmax(dot, axis=1)
        hist = jnp.zeros(vocab.shape[0], jnp.float32).at[assign].add(
            valid.astype(jnp.float32))
    else:
        topv, topi = jax.lax.top_k(dot, soft_k)
        w = jnp.exp(0.02 * (topv - topv[:, :1]).astype(jnp.float32))
        hist = jnp.zeros(vocab.shape[0], jnp.float32).at[topi].add(
            w * valid.astype(jnp.float32)[:, None])
    if idf is not None:
        hist = hist * jnp.maximum(idf, 0.0)
    return hist / jnp.maximum(jnp.linalg.norm(hist), 1e-9)


@jax.jit
def score_all(query_hist, kf_hists, kf_mask):
    """Similarity of a query histogram vs all keyframes: (W,),(K,W),(K,) -> (K,).
    Replaces KeyFrameDatabase::DetectLoopCandidates' accumulation."""
    s = kf_hists @ query_hist
    return jnp.where(kf_mask, s, -1.0)
