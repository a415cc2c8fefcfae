"""Parity of the port's matchers — kernel K2's plain twin (best-2 rows and,
in the same call, the column argmin) and the matchers built on it — with the
JAX package's masked_best2 / mutual_filter / search_by_projection /
stereo_row_match; and a model of the kernel's decomposition (tiles merged by
key, the column butterfly) against the whole-row plain twin.

Tolerance: exact. Hamming distances are integers and every tie rule (first
index; only the best position removed for the second) is reproduced, so the
inputs are built to tie a lot: descriptors drawn from a small pool with a
few flipped bits.
"""

import gc
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_vio_fixes_tpu.ops import matching as jm
from orb_slam3_vio_fixes_tpu_torch.ops import matching as tm

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Free the JAX executables this module compiled once it ends: each holds
    hundreds of memory mappings, and an xdist worker that runs several
    compile-heavy files can reach the per-process mapping limit."""
    yield
    jax.clear_caches()
    gc.collect()


POOL = np.random.default_rng(99).integers(0, 2**32, size=(64, 8),
                                          dtype=np.uint64).astype(np.uint32)


def tie_desc(rng, n, pool=6, flips=3):
    """uint32 descriptors from the first `pool` rows of a shared pool with a
    few flipped bits: queries and trains drawn this way match closely and
    tie often."""
    d = POOL[rng.integers(0, pool, n)].copy()
    for _ in range(flips):
        w = rng.integers(0, 8, n)
        b = rng.integers(0, 32, n).astype(np.uint32)
        d[np.arange(n), w] ^= np.left_shift(np.uint32(1), b)
    return d


def t(x):
    """numpy -> torch, uint32 descriptor words as int32 bit patterns."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def n(x):
    return x.detach().cpu().numpy()


def _check_against_reference(dq, dt, mask):
    """hamming_match with and without columns against the JAX package's
    masked_best2, the ratio branch's second index and mutual_filter."""
    Q = dq.shape[0]
    dist = jm.hamming_matrix(jnp.asarray(dq), jnp.asarray(dt))
    np.testing.assert_array_equal(n(tm.hamming_matrix(t(dq), t(dt))), np.asarray(dist))
    bi, b, s = jm.masked_best2(dist, jnp.asarray(mask))
    # second index as search_by_projection's ratio branch computes it
    d = jnp.where(jnp.asarray(mask), dist, jm.BIG)
    si = jnp.argmin(d.at[jnp.arange(Q), bi].set(jm.BIG), axis=1)
    mut = jm.mutual_filter(bi, b, dist, jnp.asarray(mask))
    for cols in (False, True):
        got = tm.hamming_match(t(dq), t(dt), t(mask), cols)
        for a, ref in zip(got[:4], (bi, b, s, si)):
            np.testing.assert_array_equal(n(a), np.asarray(ref))
        if cols:
            np.testing.assert_array_equal(n(tm.mutual_ok(got[4], got[0])),
                                          np.asarray(mut))
        else:
            assert got[4] is None


@pytest.mark.parametrize("density", [1.0, 0.2, 0.01, 0.0])
def test_best2_and_cols_match_reference(rng, density):
    Q, T = 96, 80
    dq, dt = tie_desc(rng, Q), tie_desc(rng, T)
    _check_against_reference(dq, dt, rng.random((Q, T)) < density)


@pytest.mark.parametrize("Q,T,density", [
    (1, 1, 1.0),        # one pair: no second exists
    (1, 1, 0.0),
    (33, 1, 0.5),
    (40, 70, 0.0),      # every row masked
    (50, 257, 0.3),     # T past one 256-train tile, not a multiple of 32
    (3, 300, 0.05),
])
def test_hamming_match_edges(rng, Q, T, density):
    dq, dt = tie_desc(rng, Q, pool=3), tie_desc(rng, T, pool=3)
    mask = rng.random((Q, T)) < density
    mask[Q // 2] = False                               # an empty row in every case
    _check_against_reference(dq, dt, mask)


KEY_MAX = np.iinfo(np.int64).max


def _merge2(a1, a2, b1, b2):
    """The kernel's merge of top-2 key sets (b1 < b2) into (a1 < a2)."""
    take = b1 < a1
    return np.where(take, b1, a1), np.where(take, np.minimum(a1, b2), np.minimum(a2, b1))


def _kernel_model(d, tq, tt, rng):
    """K2's decomposition on the (Q, T) masked distances d: tile-local keys
    (d << 8 | t_local) for rows and (d << 5 | lane) for columns, per-tile
    row top-2 widened to (d << 32 | t) and merged across tiles in a random
    order, per-tile column minima merged by min, all-BIG column partials
    dropped except in the first query strip."""
    Q, T = d.shape
    big = tm.BIG
    k1 = np.full(Q, KEY_MAX)
    k2 = np.full(Q, KEY_MAX)
    col = np.full(T, KEY_MAX)
    for t0 in rng.permutation(np.arange(0, T, tt)):
        tile = d[:, t0:t0 + tt]
        local = np.sort((tile << 8) | np.arange(tile.shape[1]), axis=1)
        r1 = local[:, 0]
        r2 = local[:, 1] if tile.shape[1] > 1 else np.full(Q, KEY_MAX)
        widen = lambda r: np.where(r == KEY_MAX, KEY_MAX,
                                   ((r >> 8) << 32) | (t0 + (r & 255)))
        k1, k2 = _merge2(k1, k2, widen(r1), widen(r2))
        for q0 in rng.permutation(np.arange(0, Q, tq)):
            strip = tile[q0:q0 + tq]
            ck = ((strip << 5) | np.arange(strip.shape[0])[:, None]).min(axis=0)
            cd = ck >> 5
            key = (cd << 32) | (q0 + (ck & 31))
            keep = (cd < big) | (q0 == 0)
            sl = slice(t0, t0 + tile.shape[1])
            col[sl] = np.where(keep, np.minimum(col[sl], key), col[sl])
    s, si = k2 >> 32, k2 & 0xFFFFFFFF
    none = s >= big
    return ((k1 & 0xFFFFFFFF).astype(np.int32), (k1 >> 32).astype(np.int32),
            np.where(none, big, s).astype(np.int32),
            np.where(none, 0, si).astype(np.int32), (col & 0xFFFFFFFF).astype(np.int32))


@pytest.mark.parametrize("tq,tt", [(32, 256), (7, 13), (1, 5), (32, 1), (5, 256)])
def test_tiled_merge_equals_whole_row(rng, tq, tt):
    """The merge rules the kernel relies on hold on ragged tiles: partial
    top-2 sets and partial column minima merged in any order give the
    whole-row plain twin's answer, ties and empty rows included."""
    Q, T = 70, 300
    dq, dt = tie_desc(rng, Q, pool=4), tie_desc(rng, T, pool=4)
    mask = rng.random((Q, T)) < 0.2
    mask[5] = False
    mask[:, 7] = False
    dist = n(tm.hamming_matrix(t(dq), t(dt))).astype(np.int64)
    d = np.where(mask, dist, tm.BIG)
    got = _kernel_model(d, tq, tt, rng)
    ref = tm.match_plain(t(dq), t(dt), t(mask), cols=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, n(b))


def test_column_butterfly_model(rng):
    """The kernel's five-step shuffle butterfly (fold_columns<16..1>): lane j
    ends with the minimum over the 32 lanes of column j."""
    ck = rng.integers(0, 1 << 25, (32, 32))            # [lane, column]
    ref = ck.min(axis=0)
    lanes = np.arange(32)
    for s in (16, 8, 4, 2, 1):
        upper = (lanes & s) != 0
        nxt = ck.copy()
        for i in range(s):
            keep = np.where(upper, ck[:, i + s], ck[:, i])
            send = np.where(upper, ck[:, i], ck[:, i + s])
            nxt[:, i] = np.minimum(keep, send[lanes ^ s])
        ck = nxt
    np.testing.assert_array_equal(ck[:, 0], ref)


def _proj_inputs(rng, M, N):
    proj_uv = rng.uniform(0, 100, (M, 2)).astype(np.float32)
    feat_uv = np.concatenate([proj_uv[: N // 2] + rng.normal(0, 2, (N // 2, 2)),
                              rng.uniform(0, 100, (N - N // 2, 2))]).astype(np.float32)
    return dict(
        proj_uv=proj_uv, proj_valid=rng.random(M) < 0.9,
        proj_desc=tie_desc(rng, M), proj_octave=rng.integers(0, 4, M).astype(np.int32),
        radius=rng.uniform(3, 12, M).astype(np.float32), feat_uv=feat_uv,
        feat_valid=rng.random(N) < 0.9, feat_desc=tie_desc(rng, N),
        feat_octave=rng.integers(0, 4, N).astype(np.int32))


@pytest.mark.parametrize("variant", ["plain", "taken_stereo_ratio", "fuse"])
def test_search_by_projection(rng, variant):
    M, N = 120, 100
    a = _proj_inputs(rng, M, N)
    kw = {}
    if variant == "taken_stereo_ratio":
        a["feat_taken"] = rng.random(N) < 0.2
        a["proj_ur"] = (a["proj_uv"][:, 0] - 5).astype(np.float32)
        a["feat_ur"] = np.where(rng.random(N) < 0.7, a["feat_uv"][:, 0] - 5,
                                -1.0).astype(np.float32)
        kw = dict(ratio=0.8)
    elif variant == "fuse":
        kw = dict(max_dist=jm.TH_LOW)
    ref = jm.search_by_projection(**{k: jnp.asarray(v) for k, v in a.items()}, **kw)
    got = tm.search_by_projection(**{k: t(v) for k, v in a.items()}, **kw)
    assert int((np.asarray(ref.idx) >= 0).sum()) > 5
    np.testing.assert_array_equal(n(got.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(n(got.dist), np.asarray(ref.dist))


def test_stereo_row_match(rng):
    N = 150
    uv_l = np.stack([rng.uniform(20, 300, N), rng.integers(0, 40, N)], 1).astype(np.float32)
    uv_r = (uv_l + np.stack([-rng.uniform(0, 30, N), rng.normal(0, 1, N)], 1)).astype(np.float32)
    desc_l = tie_desc(rng, N, pool=12, flips=6)
    desc_r = desc_l.copy()
    desc_r[:, 0] ^= rng.integers(0, 8, N).astype(np.uint32)
    oct_l = rng.integers(0, 3, N).astype(np.int32)
    oct_r = np.clip(oct_l + rng.integers(-1, 2, N), 0, 3).astype(np.int32)
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    vl, vr = rng.random(N) < 0.95, rng.random(N) < 0.95
    ref = jm.stereo_row_match(*(jnp.asarray(x) for x in (
        uv_l, vl, desc_l, oct_l, uv_r, vr, desc_r, oct_r, sf)),
        jnp.float32(0.0), jnp.float32(200.0))
    got = tm.stereo_row_match(*(t(x) for x in (uv_l, vl, desc_l, oct_l, uv_r, vr,
                                               desc_r, oct_r, sf)), 0.0, 200.0)
    assert int((np.asarray(ref[0]) >= 0).sum()) > 20
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_match_descriptors_and_rotation(rng):
    Q, T = 70, 90
    dq, dt = tie_desc(rng, Q, pool=40, flips=4), tie_desc(rng, T, pool=40, flips=4)
    vq, vt = rng.random(Q) < 0.9, rng.random(T) < 0.9
    aq = rng.uniform(-np.pi, np.pi, Q).astype(np.float32)
    at = rng.uniform(-np.pi, np.pi, T).astype(np.float32)
    ref = jm.match_descriptors(jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt),
                               jnp.asarray(vt), jnp.asarray(aq), jnp.asarray(at),
                               ratio=0.95, max_dist=jm.TH_HIGH, check_rotation=True)
    got = tm.match_descriptors(t(dq), t(vq), t(dt), t(vt), t(aq), t(at), ratio=0.95,
                               max_dist=tm.TH_HIGH, check_rotation=True)
    np.testing.assert_array_equal(n(got.idx), np.asarray(ref.idx))


def test_nanmedian_matches_jnp(rng):
    for k in (0, 1, 2, 7, 8):
        x = np.full(10, np.nan, np.float32)
        x[:k] = rng.integers(0, 60, k)
        ref = float(jnp.nanmedian(jnp.asarray(x)))
        got = float(tm.nanmedian(torch.from_numpy(x)))
        assert (np.isnan(ref) and np.isnan(got)) or ref == got
