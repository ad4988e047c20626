"""Device-parallel AMG setup kernels (SURVEY.md §7 steps 6-7).

The reference's aggregation and C/F coloring are sequential greedy loops
(reference src/Multigrid/SA-AMG.jl:119-211, coloring.jl:13-97).  Those are
re-implemented here as jitted, deterministic fixed-point iterations over a
padded ELL neighbor graph — every step is a gather + masked reduction over
the K-wide neighbor axis (VPU work), and the outer loop is a
`lax.while_loop`, so a 512^2 (260k-node) setup is a handful of device
dispatches instead of 260k Python iterations.

Two kernels:

* `device_aggregation(S)` — root-based aggregation equivalent to the
  greedy neighborhood aggregation: a distance-2 maximal independent set
  (Luby iterations with deterministic permuted keys; hub nodes get lowest
  priority, mirroring the greedy pass-1/2 hub deferral) seeds the
  aggregates, a second MIS layer over the uncovered shell restores the
  greedy seed density, direct neighbors join their unique root, and
  remaining nodes adopt by the greedy pass-3 affinity/size score until
  none are left.  Deterministic end to end.

  Measured vs the greedy path (512^2 DivSigGrad, sigma = exp(randn),
  V(2,1) Jacobi to 1e-8): device 24 cycles / operator complexity 2.35 vs
  greedy 33 cycles / 1.63 — ~25% fewer cycles for ~40% more per-cycle
  work, and more robust on rougher sigma (exp(2*randn): reaches 4.5e-8
  in 60 cycles where greedy stalls at 5.5e-7).  A lex-priority variant
  that reproduces the greedy seed set EXACTLY is a measured dead end:
  the lex wavefront needs ~530 Luby rounds at 512^2 (21 s on-chip vs
  ~15 rounds for permuted keys).

* `pmis_coloring(S)` — the PMIS parallel C/F splitting (the standard
  parallel replacement for the reference's greedy bucketed coloring):
  weights = strong-influence degree + deterministic fractional tiebreak;
  each round promotes unassigned nodes whose weight beats every unassigned
  strong neighbor to C and demotes their unassigned neighbors to F.  By
  construction every F node has a strong C neighbor; the F-F common-C
  PAIR property direct interpolation also needs is restored by
  `enforce_common_c` (vectorised reference pass 2) — measured r4: PMIS
  without it needs 3x the common-C cycle count on rough DivSigGrad.

Both return HOST numpy arrays (the rest of setup is host CSR algebra).
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..config import HIGHEST

__all__ = ["device_aggregation", "pmis_coloring", "enforce_common_c",
           "ell_graph"]

_K_CAP = 32     # keep the strongest _K_CAP neighbors of pathological hubs


def ell_graph(S: sp.csr_matrix, k_cap: int = _K_CAP):
    """Padded ELL of the strength graph, self-loops excluded.

    Returns (idx, val): (n, K) int32 neighbor indices (-1 = padding) and
    float32 strength values (0 at padding).  Rows wider than `k_cap` keep
    their `k_cap` strongest entries — hubs beyond that width are deferred
    to adoption, which matches the greedy algorithm's hub handling.
    """
    S = S.tocsr()
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, np.abs(S.data)
    counts = np.diff(indptr)
    K = int(min(max(counts.max() if n else 0, 1), k_cap))
    idx = np.full((n, K), -1, dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    for i in range(n):      # host packing; vectorised below when uniform
        lo, hi = indptr[i], indptr[i + 1]
        nb = indices[lo:hi]
        vv = data[lo:hi]
        keep = nb != i
        nb, vv = nb[keep], vv[keep]
        if len(nb) > K:
            top = np.argpartition(vv, -K)[-K:]
            nb, vv = nb[top], vv[top]
        idx[i, :len(nb)] = nb
        val[i, :len(nb)] = vv
    return idx, val


def _ell_graph_fast(S: sp.csr_matrix, k_cap: int = _K_CAP):
    """Vectorised ELL packing (no per-row Python loop) for the common case
    max_degree <= k_cap; falls back to ell_graph for hub-heavy graphs."""
    S = S.tocsr()
    n = S.shape[0]
    counts = np.diff(S.indptr)
    K = int(counts.max()) if n else 1
    if K > k_cap:
        return ell_graph(S, k_cap)
    K = max(K, 1)
    idx = np.full((n, K), -1, dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    idx[rows, pos] = S.indices
    val[rows, pos] = np.abs(S.data)
    # drop self-loops
    self_m = idx == np.arange(n, dtype=np.int32)[:, None]
    idx[self_m] = -1
    val[self_m] = 0.0
    return idx, val


def _nbr_max(x, idx, fill):
    """max over {x[i]} ∪ {x[j] : j in nbrs(i)} with -1 padding ignored."""
    g = jnp.where(idx >= 0, x[jnp.clip(idx, 0)], fill)
    return jnp.maximum(x, jnp.max(g, axis=1))


def _mis_rounds(idx, key, covered0, hops):
    """Distance-`hops` maximal independent set by deterministic Luby rounds.

    key: (n,) distinct int32 priorities (higher wins; int avoids float
    mantissa collisions at large n).  Nodes with covered0 set can neither
    seed nor block — they are outside the subgraph.  Returns bool roots."""
    NEG = jnp.asarray(-1, key.dtype)
    ZERO = jnp.asarray(0, key.dtype)

    def cond(state):
        root, covered = state
        return jnp.any(~root & ~covered)

    def body(state):
        root, covered = state
        alive = ~root & ~covered
        k = jnp.where(alive, key, NEG)
        for _ in range(hops):
            k = _nbr_max(k, idx, NEG)
        new_root = alive & (jnp.where(alive, key, NEG) == k)
        root = root | new_root
        r = root.astype(key.dtype)
        for _ in range(hops):
            r = _nbr_max(r, idx, ZERO)
        covered = covered | ((r > 0) & ~root)
        return root, covered

    n = key.shape[0]
    root, _ = jax.lax.while_loop(cond, body,
                                 (jnp.zeros(n, bool), covered0))
    return root


@functools.partial(jax.jit, static_argnames=("n", "hops"))
def _mis_roots(idx, key, n, hops=2):
    root = _mis_rounds(idx, key, jnp.zeros(n, bool), hops)
    # SHELL RE-SEEDING: a random-priority MIS-2 packs seeds ~30% sparser
    # than the greedy lex scan (lex-priority Luby reproduces the greedy
    # seed set exactly but needs O(wavefront) ~ 500 rounds at 512^2 —
    # measured 21 s on the chip; random keys converge in ~15 rounds).  The
    # nodes left at distance exactly `hops` from every seed form a shell;
    # seeding a second, distance-1-independent layer among them restores
    # the greedy aggregate density (and with it the greedy convergence
    # factor) at ~10 extra rounds.
    if hops > 1:
        near = root
        near = near | (_nbr_max(near.astype(jnp.int8), idx,
                                jnp.int8(0)) > 0)
        shell = ~near
        # distance-2 independence for the second layer too (distance-1
        # re-seeding doubles the aggregate count and explodes operator
        # complexity — measured opc 6-22 at 512^2; distance-3 adds
        # aggregates without improving convergence); the keys' distances
        # propagate through covered nodes, so layer-2 seeds stay >= 3
        # apart in the FULL graph metric
        root2 = _mis_rounds(idx, key, ~shell, hops)
        root = root | root2
    return root


@functools.partial(jax.jit, static_argnames=("n",))
def _assign_labels(idx, val, rank, root, n):
    """Root labels, then affinity-scored adoption rounds: every unlabeled
    node with a labeled neighbor joins the neighboring aggregate with the
    best (sum of strengths into it) / (its size) — the greedy pass-3 score
    (reference SA-AMG.jl:174-205).  Ties break on rank.  Layer-1 root
    neighbors see exactly one aggregate in round 1 (MIS-2 roots are >= 3
    apart); nodes between a layer-1 and a shell root pick by affinity."""
    nodes = jnp.arange(n, dtype=jnp.int32)
    label = jnp.where(root, nodes, jnp.int32(-1))
    tie = (1.0 / (4 * n)) * rank[jnp.clip(idx, 0)]
    valid = idx >= 0
    valf = val.astype(jnp.float32)

    def cond(state):
        return jnp.any(state < 0)

    def body(label):
        nlab = jnp.where(valid, label[jnp.clip(idx, 0)], jnp.int32(-1))
        ok = nlab >= 0
        # per-slot affinity: sum of strengths to neighbors sharing that
        # slot's label (groups the K neighbor slots by label)
        same = (nlab[:, :, None] == nlab[:, None, :]) & ok[:, :, None]
        aff = jnp.einsum("ikj,ik->ij", same.astype(valf.dtype), valf,
                         precision=HIGHEST)
        size = jax.ops.segment_sum(
            (label >= 0).astype(jnp.float32), jnp.clip(label, 0), n)
        s = aff / jnp.maximum(size[jnp.clip(nlab, 0)], 1.0) + tie
        s = jnp.where(ok, s, -jnp.inf)
        j = jnp.argmax(s, axis=1)
        best = nlab[nodes, j]
        has = jnp.any(ok, axis=1)
        un = label < 0
        new_label = jnp.where(un & has, best, label)
        # nodes with NO neighbors at all become singletons; nodes whose
        # neighbors are all unassigned wait for the next round
        deg0 = ~jnp.any(valid, axis=1)
        return jnp.where(un & deg0, nodes, new_label)

    return jax.lax.while_loop(cond, body, label)


def device_aggregation(S: sp.csr_matrix, tau: float = 3.0,
                       seed: int = 0, hops: int = 2) -> np.ndarray:
    """aggr[i] = root node of i's aggregate — device-parallel equivalent of
    `neighborhood_aggregation` (reference SA-AMG.jl:119-211).  Returns a
    host int64 array consumable by `aggregation_to_tentative_p`.

    hops: seed-separation distance.  2 = classic MIS-2 neighborhood
    aggregation; 1 = denser seeding (smaller aggregates, slower coarsening,
    stronger cycles)."""
    n = S.shape[0]
    idx_np, val_np = _ell_graph_fast(S)
    counts = (idx_np >= 0).sum(axis=1)
    hub = counts > tau * max(counts.mean(), 1e-300)
    # deterministic pseudo-random distinct priorities (fixed permutation;
    # O(log n) Luby rounds), hubs always outranked — mirrors the greedy
    # pass-1/2 hub deferral (SA-AMG.jl:119-141); the shell re-seeding in
    # _mis_roots compensates the sparser random packing (see there)
    rank = np.empty(n, dtype=np.int64)
    rank[np.random.RandomState(seed).permutation(n)] = np.arange(n)
    key = (rank + n * (~hub)).astype(np.int32)
    idx = jnp.asarray(idx_np)
    val = jnp.asarray(val_np)
    root = _mis_roots(idx, jnp.asarray(key), n, hops)
    label = _assign_labels(idx, val,
                           jnp.asarray(rank / n, jnp.float32), root, n)
    return np.asarray(label, dtype=np.int64)


@functools.partial(jax.jit, static_argnames=("n",))
def _pmis_loop(idx, w, n):
    NEG = jnp.asarray(-1.0, w.dtype)

    def cond(state):
        return jnp.any(state < 0)

    def body(state):
        un = state < 0
        k = jnp.where(un, w, NEG)
        k1 = _nbr_max(k, idx, NEG)
        new_c = un & (k == k1)             # strict local max among unassigned
        st = jnp.where(new_c, jnp.int8(1), state)
        c = (st == 1).astype(w.dtype)
        c1 = _nbr_max(c, idx, jnp.asarray(0.0, w.dtype))
        st = jnp.where((st < 0) & (c1 > 0), jnp.int8(0), st)
        return st

    state0 = jnp.full((n,), jnp.int8(-1))
    return jax.lax.while_loop(cond, body, state0)


def pmis_coloring(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """PMIS C/F splitting on the device; 1 = coarse, 0 = fine (same
    convention as `cf_coloring_first`).  Every F node is guaranteed a
    strong C neighbor; isolated nodes are F (as in the greedy coloring)."""
    n = S.shape[0]
    idx_np, _ = _ell_graph_fast(S)
    counts = (idx_np >= 0).sum(axis=1)
    rank = np.empty(n, dtype=np.float64)
    rank[np.random.RandomState(seed).permutation(n)] = np.arange(n)
    w = (counts + (rank + 0.5) / (n + 1)).astype(np.float32)
    state = np.asarray(_pmis_loop(jnp.asarray(idx_np), jnp.asarray(w), n))
    coloring = (state == 1).astype(np.int64)
    coloring[counts == 0] = 0              # isolated nodes stay F
    return coloring


def enforce_common_c(S: sp.csr_matrix, coloring: np.ndarray,
                     max_rounds: int = 50) -> np.ndarray:
    """Vectorised F-F common-C enforcement (reference pass 2,
    coloring.jl:104-122): promote F nodes until every strong F-F pair
    shares a strong C neighbor.

    PMIS alone guarantees each F node A strong C neighbor, but direct
    interpolation also needs the PAIR property — without it the r4
    contract test measured 35 cycles vs 12 for common-C on 64^2 rough
    DivSigGrad (tests/test_device_agg.py).  The reference enforces it with
    a sequential sweep; this is the bulk-sparse-algebra equivalent:

      * uncovered pairs: (i, j) strong, both F, with (S_F C S_F)[i, j] = 0
        where the middle factor selects C columns — one pattern SpGEMM,
      * promotion: among uncovered nodes, promote the round's local maxima
        by (uncovered-pair count, -index) against their uncovered partners
        — an independent-set step, so no two adjacent endpoints both
        promote in a round; deterministic.

    Terminates because every round strictly covers the pairs incident to
    promoted nodes; max_rounds is a safety net (typical: 2-4 rounds).
    """
    coloring = coloring.astype(np.int64).copy()
    n = S.shape[0]
    Sp = sp.csr_matrix(S, copy=True)
    Sp.setdiag(0)
    Sp.eliminate_zeros()
    Sp.data = np.ones_like(Sp.data)
    for _ in range(max_rounds):
        c = coloring == 1
        f = ~c
        SF = Sp[f][:, f]                      # strong F-F adjacency
        if SF.nnz == 0:
            break
        # common-C counts between F pairs: (S[f, C] @ S[C, f])
        SC = Sp[f][:, c]
        P2 = (SC @ SC.T).tocsr()
        cov = np.asarray(P2[SF.astype(bool)]).ravel() if SF.nnz else \
            np.zeros(0)
        # rows/cols of uncovered pairs, in F-local indices
        coo = SF.tocoo()
        unc = cov == 0
        if not unc.any():
            break
        fi = np.where(f)[0]
        ui, uj = coo.row[unc], coo.col[unc]   # F-local endpoints
        u_cnt = np.bincount(ui, minlength=len(fi)) \
            + np.bincount(uj, minlength=len(fi))
        # lexicographic key (count, -local index); promote i iff its key
        # beats EVERY uncovered partner's key
        key = u_cnt.astype(np.float64) * n - np.arange(len(fi))
        lose = np.zeros(len(fi), dtype=bool)
        lose[ui[key[ui] <= key[uj]]] = True
        lose[uj[key[uj] <= key[ui]]] = True
        winners = np.unique(np.concatenate([ui[~lose[ui]], uj[~lose[uj]]]))
        if len(winners) == 0:                 # break symmetric stalemates
            winners = np.unique(np.minimum(ui, uj))
        coloring[fi[winners]] = 1
    return coloring
