"""The selection schemes of the exact top-k kernel (`knn_topk/kernel.cu`),
the IVF scan (`knn_ivf/kernel.cu`), the fused IVF-PQ shortlist
(`knn_ivf/pq_kernel.cu`) and their shared per-query selection
(`knn_ivf/select.cuh`), emulated step for step in numpy on the CPU (the
CUDA kernels run only on a GPU: `test_torch_gpu.py` holds them against
their plain versions there).

  * the shared selection (`block_topk`): radix select with 11-, 11- and
    10-bit digits over the score, then the id, stopping once the digit's
    bin holds just the keys still needed; above 2,048 keys in rounds of
    1,024 under a key ceiling (`select_topk_kernel`);
  * kernel 1, k <= 128: every block keeps a running top-k per query over
    its 64-row tiles, with the list's smallest key as threshold and a radix
    select (8-bit digits, early exit) when a tile overflows the list (the
    kernel sorts in registers instead where at most 128 keys meet, which
    keeps the same set); the
    last block to finish merges every block's sorted list, bounded below by
    the k-th largest of the lists' first ceil(k / lists) entries;
  * kernel 1, k > 128: a per-query histogram of the keys' top 10 bits, the
    threshold bin (refined by histograms of the next 11 bits of its keys,
    twice at most, where it leaves more than the buffer holds), the
    compaction into a bounded candidate buffer and the selection over it,
    or over all keys where the buffer still overflows (ties);
  * kernel 4: queries in tiles of 16; the block of (row chunk, slot, query)
    owns its list where no earlier (query, slot) of the tile probes it and
    scores the chunk for every query of the tile that probes the list; a
    ticket per query counts its keys, and a selector block selects the
    query once they are all written;
  * kernel 5, fused: the eight blocks of a query's cluster take the probes
    p = r (mod 8) and put their keys into the leader, which selects.

Each is held against the exact order of the selection keys (score
descending, then row id ascending; NaN, -inf and masked rows never
selected), against the port's plain versions and against the JAX
package's references on the same numpy inputs.  Tolerances: the scores of
an emulation are the plain version's own scores, so they must be equal;
against the JAX references 1e-5 (kNN, IVF) and rtol 1e-4 / atol 1e-5
(ADC), the reference tests' tolerances.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.knn_ivf import ops as ivf_ops  # noqa: E402
from repro_torch.kernels.knn_ivf.pq import unpack_codes_cm  # noqa: E402
from repro_torch.kernels.knn_ivf.ref import (adc_table, ivf_probe,  # noqa: E402
                                             ivf_scan_plain, ivfpq_adc_plain)
from repro_torch.kernels.knn_topk import ops as knn_ops  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_reference  # noqa: E402

U64 = np.uint64
TILE = 64          # knn_topk/kernel.cu: TN
CLUSTER = 8        # pq_kernel.cu: CL

# ---------------------------------------------------------------------------
# keys (knn_ivf/select.cuh: make_key, key_score, key_id)
# ---------------------------------------------------------------------------


def make_keys(scores, ids, ok=None):
    """(score, id) -> 64-bit selection keys: the score's bits in an
    order-preserving unsigned form, then ~id; 0 where masked, NaN or
    -inf."""
    s = np.ascontiguousarray(scores, np.float32)
    b = s.view(np.uint32).astype(U64)
    b = np.where(b & U64(0x80000000), b ^ U64(0xFFFFFFFF), b ^ U64(0x80000000))
    key = (b << U64(32)) | (U64(0xFFFFFFFF) - np.asarray(ids).astype(U64))
    valid = (s > -np.inf) & ~np.isnan(s)
    if ok is not None:
        valid &= ok
    return np.where(valid, key, U64(0))


def key_scores(keys):
    b = (keys >> U64(32)).astype(np.uint32)
    b = np.where(b & np.uint32(0x80000000), b ^ np.uint32(0x80000000),
                 b ^ np.uint32(0xFFFFFFFF))
    return np.where(keys != 0, b.view(np.float32), -np.inf).astype(np.float32)


def key_ids(keys):
    low = (keys & U64(0xFFFFFFFF)).astype(np.int64)
    return np.where(keys != 0, 0xFFFFFFFF - low, -1).astype(np.int32)


def decode(sel, k):
    """Sorted keys (any number) -> (scores (k,), ids (k,)), padded with
    -inf / -1."""
    sel = np.sort(np.asarray(sel, U64))[::-1][:k]
    sel = np.concatenate([sel, np.zeros(k - len(sel), U64)])
    return key_scores(sel), key_ids(sel)


def exact_topk(keys, k):
    """The contract: the k largest nonzero keys, descending."""
    return decode(keys[keys != 0], k)


# ---------------------------------------------------------------------------
# radix select (topk_common.cuh: warp_topk_threshold; pq_kernel.cu)
# ---------------------------------------------------------------------------


def topk_threshold(keys, k, widths=(8,) * 8):
    """T with exactly min(k, n) nonzero keys >= T (T >= 1): digits of the
    given widths from the top, stopping once the digit's bin holds just
    the keys still needed."""
    keys = np.asarray(keys, U64)
    keys = keys[keys != 0]
    prefix, mask, need, shift = 0, 0, k, 64
    for wd in widths:
        shift -= wd
        match = keys[(keys & U64(mask)) == U64(prefix)]
        digits = ((match >> U64(shift)) & U64((1 << wd) - 1)).astype(np.int64)
        hist = np.bincount(digits, minlength=1 << wd)
        above = np.cumsum(hist[::-1])[::-1]          # keys with digit >= d
        if above[0] < need:
            return 1                                  # fewer than k keys
        d = int(np.nonzero(above >= need)[0].max())
        cum = int(above[d] - hist[d])
        need -= cum
        prefix |= d << shift
        mask |= ((1 << wd) - 1) << shift
        if hist[d] == need:
            return prefix or 1
    return prefix


SEL_WIDTHS = (11, 11, 10) * 2    # select.cuh: block_topk's digits
SEL_KMAX = 1024                  # select.cuh: keys a round of select_topk
BLOCK_KMAX = 2048                # select.cuh: SEL_BLOCK_KMAX


def block_topk(keys, k, ceil=None):
    """select.cuh `block_topk`: the top k nonzero keys below ``ceil``,
    descending, zero-padded to k, and the number of digit passes it took.
    A key that occurs more than once is kept as often as it occurs."""
    keys = np.asarray(keys, U64)
    keys = keys[(keys != 0) & (keys < U64(ceil) if ceil is not None
                               else keys != 0)]
    prefix, mask, need, shift, thr, copies = 0, 0, k, 64, 1, 0
    passes = 0
    for wd in SEL_WIDTHS:
        passes += 1
        shift -= wd
        match = keys[(keys & U64(mask)) == U64(prefix)]
        digits = ((match >> U64(shift)) & U64((1 << wd) - 1)).astype(np.int64)
        hist = np.bincount(digits, minlength=1 << wd)
        above = np.cumsum(hist[::-1])[::-1]
        if above[0] < need:
            break                                    # fewer than k: all
        d = int(np.nonzero(above >= need)[0].max())
        need -= int(above[d] - hist[d])
        prefix |= d << shift
        mask |= ((1 << wd) - 1) << shift
        thr = prefix or 1
        if hist[d] == need:
            break
        if shift == 0:                               # copies of one key
            thr, copies = prefix + 1, need
    surv = keys[keys >= U64(thr)]
    surv = np.concatenate([surv, np.full(copies, prefix, U64)])[:k]
    out = np.sort(surv)[::-1]
    return np.concatenate([out, np.zeros(k - len(out), U64)]), passes


def select_rounds(keys, k):
    """select.cuh `select_topk`: rounds of at most 1,024 keys, each below
    the last key of the round before (its ceiling)."""
    out, ceil = [], None
    for col0 in range(0, k, SEL_KMAX):
        part, _ = block_topk(keys, min(SEL_KMAX, k - col0), ceil)
        out.append(part)
        ceil = int(part[-1])                        # 0: nothing below
    return np.concatenate(out)


@pytest.mark.parametrize("kind,n,k", [
    ("gaussian", 3200, 100), ("gaussian", 3200, 2048), ("gaussian", 50, 100),
    ("rounded", 3200, 100), ("rounded", 5000, 1500), ("all equal", 700, 300),
    ("masked", 3200, 100), ("one", 1, 1)])
def test_block_topk_stops_early_and_selects_exactly(kind, n, k):
    """The digits stop as soon as the bin holds the keys still needed:
    distinct scores stop on the score's digits (passes <= 3), equal scores
    go on into the id's; the set is always the exact top k."""
    rng = np.random.default_rng(n + k)
    s = rng.normal(size=n).astype(np.float32)
    if kind == "rounded":
        s = np.round(s, 1).astype(np.float32)        # ties
    elif kind == "all equal":
        s[:] = 0.25
    ok = rng.random(n) > 0.3 if kind == "masked" else None
    keys = make_keys(s, rng.permutation(n), ok)
    got, passes = block_topk(keys, k)
    np.testing.assert_array_equal(key_scores(got), exact_topk(keys, k)[0])
    np.testing.assert_array_equal(key_ids(got), exact_topk(keys, k)[1])
    if kind in ("gaussian", "masked") and k < int((keys != 0).sum()):
        assert passes <= 3, passes
    if kind == "all equal":
        assert passes > 3
    if k >= int((keys != 0).sum()):
        assert passes == 1                           # fewer than k: all


def test_block_topk_keeps_copies_of_a_key():
    """A list probed twice by one query gives every key twice; the copies
    of the k-th key fill the slots the keys above it leave."""
    rng = np.random.default_rng(2)
    keys = make_keys(rng.normal(size=300).astype(np.float32), np.arange(300))
    both = np.concatenate([keys, keys])
    for k in (1, 2, 3, 101, 600, 700):
        got, _ = block_topk(both, k)
        want = np.sort(both)[::-1][:k]
        want = np.concatenate([want, np.zeros(k - len(want), U64)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1024, 1025, 2049, 3000, 5000])
def test_select_rounds_under_a_ceiling_give_the_exact_top_k(k):
    rng = np.random.default_rng(k)
    s = np.round(rng.normal(size=4000), 2).astype(np.float32)   # ties
    keys = make_keys(s, np.arange(4000), rng.random(4000) > 0.1)
    got = select_rounds(keys, k)
    np.testing.assert_array_equal(key_scores(got), exact_topk(keys, k)[0])
    np.testing.assert_array_equal(key_ids(got), exact_topk(keys, k)[1])


# ---------------------------------------------------------------------------
# kernel 1, k <= 128
# ---------------------------------------------------------------------------


def block_lists(keys, k, nrb):
    """keys (N,) of one query -> (nrb, k) sorted lists, one per row range of
    whole 64-row tiles, each kept as the kernel keeps its running list."""
    N = len(keys)
    ntiles = -(-N // TILE)
    part = np.zeros((nrb, k), U64)
    for rb in range(nrb):
        lst = np.zeros(0, U64)
        lmin = U64(0)
        for t in range(ntiles * rb // nrb, ntiles * (rb + 1) // nrb):
            tile = keys[t * TILE:(t + 1) * TILE]
            lo = U64(1) if len(lst) < k else lmin + U64(1)
            cand = tile[tile >= lo]
            if not len(cand):
                continue
            if len(lst) + len(cand) <= k:
                lst = np.concatenate([lst, cand])
            else:
                both = np.concatenate([lst, cand])
                thr = U64(topk_threshold(both, k))
                lst = both[(both >= thr) & (both != 0)]
                assert len(lst) == k
            if len(lst) == k:
                lmin = lst.min()
        part[rb, :len(lst)] = np.sort(lst)[::-1]
    return part


def merge_lists(part, k):
    """The last block's merge of (nrb, k) sorted lists."""
    nrb = part.shape[0]
    jh = -(-k // nrb)
    t0 = U64(topk_threshold(part[:, :jh].ravel(), k))
    cand = [x for b in range(nrb) if part[b, 0] >= t0
            for x in part[b] if x >= t0]
    cand = np.asarray(cand, U64)
    thr = U64(topk_threshold(cand, k))
    return decode(cand[cand >= thr], k)


def emulate_knn(scores, k, nrb, order=None):
    """(Q, N) scores -> (Q, k) scores and ids as kernel 1 selects them;
    ``order`` permutes the blocks' lists, as blocks finish in any order."""
    Q, N = scores.shape
    out_s, out_i = np.empty((Q, k), np.float32), np.empty((Q, k), np.int32)
    for q in range(Q):
        part = block_lists(make_keys(scores[q], np.arange(N)), k, nrb)
        if order is not None:
            part = part[order]
        out_s[q], out_i[q] = merge_lists(part, k)
    return out_s, out_i


def plain_scores(q, s):
    """The score matrix of `knn_topk_reference` (its own arithmetic)."""
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    inv = torch.rsqrt((st * st).sum(1) + 1e-12)
    return ((qt @ st.T) * inv[None, :]).numpy()


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _support(kind, N, D, rng):
    s = rng.normal(size=(N, D)).astype(np.float32)
    if kind == "border ties":
        # copies of one row on both sides of the tile and range borders
        for r in (63, 64, 127, 128, N // 2 - 1, N // 2, N - 1):
            s[r] = s[0]
    elif kind == "all equal":
        s[:] = s[0]
    elif kind == "nan rows":
        s[rng.choice(N, 7, replace=False)] = np.nan
    elif kind == "clustered":
        # near-duplicates of one row: cosines crowd [0.5, 1)
        s = (s[0] + 0.2 * s / np.sqrt(D)).astype(np.float32)
    elif kind == "tight":
        # closer duplicates: cosines within one 21-bit bin of the keys
        s = (s[0] + 0.003 * s / np.sqrt(D)).astype(np.float32)
    return s


def _check_against_plain(got_s, got_i, q, s, k):
    """The plain version computes the same scores; its ids may order ties
    differently, so the scores must be equal, every id must point at a row
    with its score, and the tail past the valid rows must be -inf / -1."""
    rs, ri = knn_topk_reference(torch.from_numpy(q), torch.from_numpy(s), k)
    rs = rs.numpy()
    sims = plain_scores(q, s)
    if np.isnan(sims).any():
        # the plain version ranks NaN first and blanks that slot; the
        # contract masks NaN rows, so compare with NaN as -inf
        masked = np.where(np.isnan(sims), -np.inf, sims)
        top = -np.sort(-masked, axis=1)[:, :k]
        top = np.concatenate([top, np.full((len(q), max(0, k - top.shape[1])),
                                           -np.inf)], 1)
        rs = top.astype(np.float32)
    np.testing.assert_array_equal(got_s, rs)
    fin = np.isfinite(got_s)
    assert (got_i[~fin] == -1).all()
    rows = np.arange(len(q))[:, None].repeat(k, 1)
    np.testing.assert_array_equal(sims[rows[fin], got_i[fin]], got_s[fin])


@pytest.mark.parametrize("kind,Q,N,k,nrb", [
    ("gaussian", 5, 1000, 10, 7),
    ("gaussian", 3, 2000, 100, 33),
    ("gaussian", 2, 700, 128, 3),
    ("border ties", 4, 512, 16, 4),
    ("all equal", 2, 300, 50, 5),
    ("nan rows", 3, 600, 20, 6),
    ("gaussian", 2, 50, 64, 1),          # k > N: -inf / -1 tail
])
def test_knn_block_lists_and_last_block_merge(kind, Q, N, k, nrb):
    rng = np.random.default_rng(N + k + nrb)
    q = _unit(rng.normal(size=(Q, 32)))
    s = _support(kind, N, 32, rng)
    scores = plain_scores(q, s)
    got_s, got_i = emulate_knn(scores, k, nrb)
    for r in range(Q):
        want = exact_topk(make_keys(scores[r], np.arange(N)), k)
        np.testing.assert_array_equal(got_s[r], want[0])
        np.testing.assert_array_equal(got_i[r], want[1])
    _check_against_plain(got_s, got_i, q, s, k)
    if kind == "all equal":
        # ties go to the lower row id, across every tile and range border
        assert (got_i == np.arange(k)).all()


def test_knn_merge_does_not_depend_on_which_block_finishes_last():
    rng = np.random.default_rng(3)
    q, s = _unit(rng.normal(size=(2, 16))), rng.normal(size=(900, 16))
    s[[63, 64, 500, 501]] = s[7]
    scores = plain_scores(q, s.astype(np.float32))
    first = emulate_knn(scores, 12, 6)
    for order in itertools.islice(itertools.permutations(range(6)), 0, 720,
                                  97):
        again = emulate_knn(scores, 12, 6, order=list(order))
        np.testing.assert_array_equal(first[0], again[0])
        np.testing.assert_array_equal(first[1], again[1])


def test_knn_emulation_matches_jax_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.knn_topk.ref import knn_topk_reference as jax_ref
    rng = np.random.default_rng(11)
    q, s = _unit(rng.normal(size=(6, 48))), rng.normal(size=(1500, 48))
    s = s.astype(np.float32)
    for k, nrb in ((10, 9), (100, 40)):
        got_s, got_i = emulate_knn(plain_scores(q, s), k, nrb)
        js, ji = jax_ref(jnp.asarray(q), jnp.asarray(s), k)
        np.testing.assert_allclose(got_s, np.asarray(js), rtol=1e-5,
                                   atol=1e-5)
        # gaussian rows: no exact ties, the neighbour sets agree
        assert all(set(a) == set(b) for a, b in zip(got_i, np.asarray(ji)))


def test_knn_neg_inf_scores_are_never_selected():
    """Rows whose score is -inf (or NaN) stay out of every list and leave
    -inf / -1 slots once the valid rows run out."""
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(2, 200)).astype(np.float32)
    scores[:, ::3] = -np.inf
    scores[0, 1::3] = np.nan
    got_s, got_i = emulate_knn(scores, 100, 4)
    assert (got_i[0] == -1).sum() == 100 - 66 and np.isneginf(got_s[0, 66:]).all()
    valid = [set(np.flatnonzero(np.isfinite(r))) for r in scores]
    assert all(set(i[i >= 0]) <= v for i, v in zip(got_i, valid))
    assert (got_i[1] >= 0).all()


@pytest.mark.parametrize("k", [1, 10, 100, 128])
def test_topk_threshold_selects_exactly_k(k):
    rng = np.random.default_rng(k)
    scores = np.round(rng.normal(size=400), 1).astype(np.float32)  # ties
    keys = make_keys(scores, np.arange(400))
    thr = topk_threshold(keys, k)
    assert ((keys >= U64(thr)) & (keys != 0)).sum() == k
    assert topk_threshold(keys[:k - 1], k) == 1 if k > 1 else True


# ---------------------------------------------------------------------------
# kernel 1, k > 128
# ---------------------------------------------------------------------------


def _threshold_bin(hist, need):
    """kernel.cu `threshold_bin`: the highest bin whose count from the top
    reaches need (bin 0 when fewer keys exist), the count above it and in
    it."""
    above = np.cumsum(hist[::-1])[::-1]
    hit = np.nonzero(above >= need)[0]
    b = int(hit.max()) if len(hit) else 0
    return b, int(above[b] - hist[b]), int(hist[b])


def emulate_keyed(keys, k, cap, hbits=10, rbits=11, levels=2):
    """(Q, N) keys -> (Q, k) scores, ids, the overflow flags and the number
    of refine levels each query took, as the histogram, refine, compaction
    and selection kernels run (kernel.cu `keyed_threshold`)."""
    Q, _ = keys.shape
    out_s, out_i = np.empty((Q, k), np.float32), np.empty((Q, k), np.int32)
    overflow, refined = np.zeros(Q, bool), np.zeros(Q, int)
    for q in range(Q):
        row = keys[q]
        valid = row[row != 0]
        b, base, hit = _threshold_bin(
            np.bincount((valid >> U64(64 - hbits)).astype(np.int64),
                        minlength=1 << hbits), k)
        prefix, bits = b, hbits
        while base + hit > cap and refined[q] < levels:
            # the next rbits bits of the keys in the bucket so far
            refined[q] += 1
            bucket = valid[(valid >> U64(64 - bits)) == U64(prefix)]
            digit = ((bucket >> U64(64 - bits - rbits))
                     & U64((1 << rbits) - 1)).astype(np.int64)
            d, excl, hit = _threshold_bin(
                np.bincount(digit, minlength=1 << rbits), k - base)
            prefix, bits, base = (prefix << rbits) | d, bits + rbits, \
                base + excl
        n_above = base + hit
        if n_above > cap:
            overflow[q] = True
            out_s[q], out_i[q] = exact_topk(row, k)      # the full-key path
            continue
        cand = np.zeros(cap, U64)
        keep = valid[valid >= U64(prefix) << U64(64 - bits)]
        assert len(keep) == n_above
        cand[:n_above] = keep
        sel = select_rounds(cand, k)                      # select_topk
        out_s[q], out_i[q] = key_scores(sel), key_ids(sel)
    return out_s, out_i, overflow, refined


@pytest.mark.parametrize("kind,N,k", [
    ("gaussian", 5000, 200), ("gaussian", 3000, 1024), ("gaussian", 700, 1024),
    ("border ties", 4000, 300), ("all equal", 5000, 300),
    ("nan rows", 2000, 129), ("clustered", 5000, 200),
    ("clustered", 9000, 1024), ("tight", 6000, 200), ("tight", 9000, 1024)])
def test_keyed_histogram_compaction_and_overflow(kind, N, k):
    rng = np.random.default_rng(N + k)
    q = _unit(rng.normal(size=(3, 32)))
    s = _support(kind, N, 32, rng)
    if kind in ("clustered", "tight"):
        q = _unit(s[:3] + 0.5 * rng.normal(size=(3, 32)) / np.sqrt(32))
    scores = plain_scores(q, s)
    keys = np.stack([make_keys(r, np.arange(N)) for r in scores])
    cap = knn_ops.candidate_cap(N, k)
    got_s, got_i, overflow, refined = emulate_keyed(keys, k, cap)
    for r in range(len(q)):
        want = exact_topk(keys[r], k)
        np.testing.assert_array_equal(got_s[r], want[0])
        np.testing.assert_array_equal(got_i[r], want[1])
    _check_against_plain(got_s, got_i, q, s, k)
    # only ties overflow the buffer; there the full-key path answers.
    # Scores crowding one 10-bit bin take a refined 21-bit threshold, and
    # scores within one 21-bit bin a 32-bit one
    assert overflow.all() == (kind == "all equal" and N > cap)
    assert not overflow.any() or kind == "all equal"
    levels = {"clustered": 1, "tight": 2, "all equal": 2}.get(kind, 0)
    assert (refined == levels).all(), refined


def test_keyed_refined_threshold_is_exact_at_a_bin_border():
    """Keys crowding one 10-bit bin, with the k-th key the last of a
    21-bit bin: the refined threshold keeps exactly the keys above it."""
    N, k = 6000, 300
    base = np.float32(0.75)
    step = np.spacing(base) * 2 ** 11          # one refined digit
    scores = (base + step * (np.arange(N) // 20)).astype(np.float32)
    keys = make_keys(scores, np.arange(N))[None]
    cap = knn_ops.candidate_cap(N, k)
    got_s, got_i, overflow, refined = emulate_keyed(keys, k, cap)
    assert refined[0] == 1 and not overflow[0]
    want = exact_topk(keys[0], k)
    np.testing.assert_array_equal(got_s[0], want[0])
    np.testing.assert_array_equal(got_i[0], want[1])


# ---------------------------------------------------------------------------
# kernel 4: ownership within query tiles, tickets and selectors
# ---------------------------------------------------------------------------

QT = 16            # knn_ivf/kernel.cu: QT, queries a tile
ROWS = 64          # knn_ivf/kernel.cu: TN, list rows a block


def tile_roles(probe, C):
    """kernel.cu `ivf_tile_kernel`: the (query, slot) pairs the block of
    each (query, slot) serves (the same for every row chunk).  An owner
    (no earlier (query, slot) of the tile probes its list) serves every
    query of the tile that probes the list, at the query's first slot on
    it; an out-of-range list id or a query's second slot on a list serves
    that slot alone; every other block serves nothing and leaves."""
    Q, P = probe.shape
    roles = {}
    for qi in range(Q):
        q0 = qi - qi % QT
        nt, me = min(QT, Q - q0), qi % QT
        for p in range(P):
            cid = int(probe[qi, p])
            if not 0 <= cid < C:
                roles[qi, p] = [(qi, p)]
                continue
            first = [next((pp for pp in range(P) if probe[q0 + j, pp] == cid),
                          None) for j in range(nt)]
            if first[me] < p:
                roles[qi, p] = [(qi, p)]
            elif any(f is not None for f in first[:me]):
                roles[qi, p] = []
            else:
                roles[qi, p] = [(q0 + j, f) for j, f in enumerate(first)
                                if f is not None]
    return roles


def ivf_plain_keys(q, probe, sup_cm, ids_cm, inv_cm):
    """(Q, P, L) keys of every (query, slot, row) in `ivf_scan_plain`'s
    arithmetic; masked where the row is padding or the slot's list id is
    out of range."""
    C, L, _ = sup_cm.shape
    pr = probe.long()
    live = (pr >= 0) & (pr < C)
    safe = torch.where(live, pr, torch.zeros_like(pr))
    sims = torch.einsum("qd,qpld->qpl", q.float(), sup_cm[safe]) \
        * inv_cm[safe]
    ids = ids_cm[safe].numpy()
    ok = (ids >= 0) & live.numpy()[:, :, None]
    return make_keys(sims.numpy().ravel(), ids.ravel(),
                     ok.ravel()).reshape(ids.shape)


def emulate_ivf(q, probe, sup_cm, ids_cm, inv_cm, k, order=None):
    """Kernel 4 at k <= 2,048, block by block in ``order`` (a permutation of
    the (chunk, slot, query) blocks; blocks finish in any order): each
    block writes its served keys and adds one to each served query's
    ticket; a query's selector selects it from the keys written so far as
    soon as its ticket counts P x chunks entries, and by then every one of
    its keys has been written.  Returns the scores, ids, the count of
    writes of every key and the list reads per tile."""
    C, L, _ = sup_cm.shape
    Q, P = probe.shape
    pr = probe.numpy()
    want = ivf_plain_keys(q, probe, sup_cm, ids_cm, inv_cm)
    roles = tile_roles(pr, C)
    nchunks = -(-L // ROWS)
    blocks = [(c, p, qi) for qi in range(Q) for p in range(P)
              for c in range(nchunks)]
    if order is not None:
        blocks = [blocks[i] for i in order]
    keys = np.zeros((Q, P * L), U64)
    writes = np.zeros((Q, P * L), int)
    ticket = np.zeros(Q, int)
    out = np.zeros((Q, k), U64)
    reads = {}
    for c, p, qi in blocks:
        served = roles[qi, p]
        rows = np.arange(c * ROWS, min(L, (c + 1) * ROWS))
        cid = int(pr[qi, p])
        if served and 0 <= cid < C:
            key = (qi // QT, cid, c)
            reads[key] = reads.get(key, 0) + 1
        for qj, pj in served:
            keys[qj, pj * L + rows] = want[qj, pj, rows]
            writes[qj, pj * L + rows] += 1
        for qj, _ in served:
            ticket[qj] += 1
            if ticket[qj] == P * nchunks:
                assert (writes[qj] == 1).all()
                out[qj], _ = block_topk(keys[qj], k)
    return key_scores(out), key_ids(out), writes, reads


def _ivf_inputs(C=12, L=100, D=24, Q=20, seed=0, short=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(3, 8, C) if short else rng.integers(L - 20, L + 1,
                                                              C)
    sup = np.zeros((C, L, D), np.float32)
    ids = np.full((C, L), -1, np.int32)
    at = 0
    for c, n in enumerate(counts):
        sup[c, :n] = rng.normal(size=(n, D))
        ids[c, :n] = np.arange(at, at + n)
        at += n
    inv = np.where(ids >= 0, 1 / np.maximum(np.linalg.norm(sup, axis=2),
                                            1e-12), 0).astype(np.float32)
    cent = _unit(rng.normal(size=(C, D)))
    q = _unit(rng.normal(size=(Q, D)))
    t = torch.from_numpy
    return t(q), t(cent), t(sup), t(ids), t(inv)


@pytest.mark.parametrize("Q,P,shared", [(16, 4, False), (17, 4, False),
                                        (33, 12, False), (1, 5, False),
                                        (20, 4, True)])
def test_ivf_tiles_write_every_key_once_and_read_each_list_once(Q, P,
                                                                shared):
    """Every (query, slot, chunk) key is written exactly once, also in a
    partial last tile (Q = 17, 33) and where all queries probe the same
    lists; each list a tile probes is read once per row chunk."""
    q, cent, sup, ids, inv = _ivf_inputs(Q=Q, seed=Q + P)
    probe = ivf_probe(q, cent, P)
    if shared:
        probe = probe[:1].expand(Q, P).contiguous()
    _, _, writes, reads = emulate_ivf(q, probe, sup, ids, inv, 10)
    assert (writes == 1).all()
    pr = probe.numpy()
    nchunks = -(-sup.shape[1] // ROWS)
    for t in range(-(-Q // QT)):
        lists = {int(c) for c in pr[t * QT:(t + 1) * QT].ravel()}
        assert {c for tt, c, _ in reads if tt == t} == lists
        assert all(reads[t, c, ch] == 1 for c in lists
                   for ch in range(nchunks))
    if shared:
        assert len(reads) == 2 * P * nchunks        # two tiles of 16 and 4


def test_ivf_duplicate_and_out_of_range_slots_are_their_own():
    """A query's second slot on one list and an out-of-range list id are
    scanned (or masked) by their own block; a padded query (all slots -1)
    comes out empty."""
    q, cent, sup, ids, inv = _ivf_inputs(Q=18, seed=4)
    probe = ivf_probe(q, cent, 4).clone()
    probe[2, 3] = probe[2, 0]
    probe[5, 1] = 99
    probe[17] = -1
    got_s, got_i, writes, _ = emulate_ivf(q, probe, sup, ids, inv, 30)
    assert (writes == 1).all()
    assert (got_i[17] == -1).all() and np.isneginf(got_s[17]).all()
    keys = ivf_plain_keys(q, probe, sup, ids, inv)
    for r in range(18):
        want = np.sort(keys[r].ravel())[::-1][:30]
        np.testing.assert_array_equal(got_i[r], key_ids(want))
    # the list probed twice gives its best rows twice, as the plain version
    top = got_i[2][got_i[2] >= 0]
    assert len(top) > len(set(top))


def test_ivf_hand_over_does_not_depend_on_block_order():
    q, cent, sup, ids, inv = _ivf_inputs(Q=21, seed=7)
    probe = ivf_probe(q, cent, 5)
    first = emulate_ivf(q, probe, sup, ids, inv, 40)
    n = 21 * 5 * 2
    rng = np.random.default_rng(0)
    for _ in range(6):
        again = emulate_ivf(q, probe, sup, ids, inv, 40,
                            order=rng.permutation(n))
        np.testing.assert_array_equal(first[0], again[0])
        np.testing.assert_array_equal(first[1], again[1])


@pytest.mark.parametrize("Q,P,k,short", [(16, 4, 10, False),
                                         (17, 12, 100, False),
                                         (5, 3, 2048, False),
                                         (16, 2, 50, True)])
def test_ivf_emulation_matches_plain_and_key_order(Q, P, k, short):
    """Equal to `ivf_scan_plain` (same scores; ids in the keys' order,
    which `torch.topk` leaves open only among ties) and to the exact key
    order; short lists leave -inf / -1 slots."""
    q, cent, sup, ids, inv = _ivf_inputs(Q=Q, seed=P + k, short=short)
    probe = ivf_probe(q, cent, P)
    got_s, got_i, _, _ = emulate_ivf(q, probe, sup, ids, inv, k)
    rs, ri = ivf_scan_plain(q, probe, sup, ids, inv, k)
    np.testing.assert_array_equal(got_s, rs.numpy())
    np.testing.assert_array_equal(got_i < 0, ri.numpy() < 0)
    keys = ivf_plain_keys(q, probe, sup, ids, inv)
    for r in range(Q):
        np.testing.assert_array_equal(got_i[r], exact_topk(keys[r].ravel(),
                                                           k)[1])
    if short:
        assert (got_i == -1).any()


def test_ivf_emulation_matches_jax_pallas():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.knn_ivf import ops as J
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(8, 32)) * 3
    s = (centers[rng.integers(0, 8, 1200)]
         + rng.normal(size=(1200, 32))).astype(np.float32)
    qn = _unit(centers[rng.integers(0, 8, 19)] + rng.normal(size=(19, 32)))
    ji = J.build_ivf_index(s, 10, seed=0)
    ti = ivf_ops.build_ivf_index(s, 10, seed=0, device="cpu")
    q = torch.from_numpy(qn)
    for nprobe, k in ((3, 20), (ti.n_clusters, 100)):
        probe = ivf_probe(q, ti.centroids, nprobe)
        got_s, got_i, _, _ = emulate_ivf(q, probe, ti.sup_cm, ti.ids_cm,
                                         ti.inv_cm, k)
        js, ji_ = J.ivf_topk(jnp.asarray(qn), ji, k, nprobe=nprobe,
                             backend="pallas", interpret=True)
        np.testing.assert_allclose(got_s, np.asarray(js), rtol=0, atol=1e-5)
        assert all(set(a) == set(b) for a, b in zip(got_i, np.asarray(ji_)))


def test_ivf_ticket_counter_is_allocated_once_per_stream(monkeypatch):
    calls = []
    monkeypatch.setattr(ivf_ops, "_tickets", {})
    monkeypatch.setattr(ivf_ops._build, "stream_ptr", lambda dev: 7)
    real = torch.zeros
    monkeypatch.setattr(ivf_ops.torch, "zeros",
                        lambda *a, **kw: calls.append(a) or real(
                            *a, **{**kw, "device": "cpu"}))
    dev = torch.device("cpu")
    t1 = ivf_ops._ticket(dev, 17)
    t2 = ivf_ops._ticket(dev, 64)
    assert t1 is t2 and len(calls) == 1 and int(t1.sum()) == 0
    t3 = ivf_ops._ticket(dev, 65)                  # more queries: grown once
    assert t3 is not t1 and t3.numel() == 65 and len(calls) == 2
    assert ivf_ops._ticket(dev, 3) is t3


# ---------------------------------------------------------------------------
# kernel 5, fused
# ---------------------------------------------------------------------------


def plain_adc_scores(q, probe, codes_cm, ids_cm, inv_cm, anchors, cb, m,
                     nbits):
    """(Q, P, L) scores and ids of the probed rows, in `ivfpq_adc_plain`'s
    arithmetic."""
    p = probe.long()
    qn, P = p.shape
    lut = adc_table(q, cb)
    codes = unpack_codes_cm(codes_cm[p], m, nbits)
    g = torch.gather(lut[:, None].expand(qn, P, m, lut.shape[2]), 3, codes)
    aq = torch.einsum("qd,qpd->qp", q.float(), anchors[p])
    sims = (g.sum(dim=2) + aq[:, :, None]) * inv_cm[p]
    return sims.numpy(), ids_cm[p].numpy()


def emulate_fused_adc(sims, ids, kk):
    """Block r of a query's cluster holds the keys of probes p = r (mod 8);
    the leader gathers them at p L + l and selects (`block_topk`)."""
    Q, P, L = sims.shape
    out_s, out_i = np.empty((Q, kk), np.float32), np.empty((Q, kk), np.int32)
    for q in range(Q):
        leader = np.zeros(P * L, U64)
        for r in range(CLUSTER):
            for p in range(r, P, CLUSTER):
                leader[p * L:(p + 1) * L] = make_keys(sims[q, p], ids[q, p],
                                                      ids[q, p] >= 0)
        sel, _ = block_topk(leader, kk)                   # block_topk
        assert (sel != 0).sum() == min(kk, int((leader != 0).sum()))
        out_s[q], out_i[q] = key_scores(sel), key_ids(sel)
    return out_s, out_i


def _pq_index(nbits, C=24, L=48, D=64, m=16, short=False, seed=0):
    rng = np.random.default_rng(seed)
    MB = m * nbits // 8
    counts = (np.arange(C) % 4 + 3) if short else np.full(C, L - 5)
    ids = np.full((C, L), -1, np.int32)
    at = 0
    for c, n in enumerate(counts):
        ids[c, :n] = np.arange(at, at + n)
        at += n
    t = torch.from_numpy
    return dict(
        codes_cm=t(rng.integers(0, 256, (C, MB, L), dtype=np.uint8)),
        ids_cm=t(ids), inv_cm=t(np.where(ids >= 0, 1 + rng.random((C, L)),
                                         0).astype(np.float32)),
        anchors=t(0.1 * rng.normal(size=(C, D)).astype(np.float32)),
        codebooks=t(0.1 * rng.normal(size=(m, 2 ** nbits, D // m))
                    .astype(np.float32)),
        centroids=t(_unit(rng.normal(size=(C, D))))), m


@pytest.mark.parametrize("nbits,Q,P,kk,short", [
    (8, 16, 8, 100, False), (4, 16, 8, 100, False), (8, 1, 8, 300, False),
    (8, 5, 24, 800, False),               # nprobe = C, 3 probes a block
    (8, 4, 3, 20, False),                 # fewer probes than blocks
    (8, 6, 2, 100, True),                 # kk above the valid rows
    (4, 3, 13, 2048, False)])
def test_fused_adc_cluster_select_matches_plain(nbits, Q, P, kk, short):
    idx, m = _pq_index(nbits, short=short, seed=P + kk)
    rng = np.random.default_rng(kk)
    q = torch.from_numpy(_unit(rng.normal(size=(Q, 64))))
    probe = ivf_probe(q, idx["centroids"], P)
    args = (q, probe, idx["codes_cm"], idx["ids_cm"], idx["inv_cm"],
            idx["anchors"], idx["codebooks"])
    sims, ids = plain_adc_scores(*args, m, nbits)
    got_s, got_i = emulate_fused_adc(sims, ids, kk)
    rs, ri = ivfpq_adc_plain(*args, kk, m, nbits)
    np.testing.assert_array_equal(got_s, rs.numpy())
    fin = np.isfinite(got_s)
    np.testing.assert_array_equal(got_i < 0, ~fin)
    if short:
        assert (~fin).any()
    # ties order by id: the keys' order, not torch.topk's
    for r in range(Q):
        keys = make_keys(sims[r].ravel(), ids[r].ravel(), ids[r].ravel() >= 0)
        want = exact_topk(keys, kk)
        np.testing.assert_array_equal(got_i[r], want[1])


def test_fused_adc_emulation_matches_jax_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.knn_ivf.ref import ivfpq_adc_reference as jax_ref
    idx, m = _pq_index(8, seed=4)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_unit(rng.normal(size=(7, 64))))
    probe = ivf_probe(q, idx["centroids"], 6)
    sims, ids = plain_adc_scores(q, probe, idx["codes_cm"], idx["ids_cm"],
                                 idx["inv_cm"], idx["anchors"],
                                 idx["codebooks"], m, 8)
    got_s, got_i = emulate_fused_adc(sims, ids, 150)
    j = {n: jnp.asarray(v.numpy()) for n, v in idx.items()}
    js, ji = jax_ref(jnp.asarray(q.numpy()), j["centroids"], j["anchors"],
                     j["codebooks"], j["codes_cm"], j["ids_cm"], j["inv_cm"],
                     150, 6, m, 8)
    np.testing.assert_allclose(got_s, np.asarray(js), rtol=1e-4, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(got_i, np.asarray(ji)))


# ---------------------------------------------------------------------------
# the wrappers' scratch sizes, grid limits and path choice
# ---------------------------------------------------------------------------


def test_knn_scratch_shapes_follow_the_path():
    s = knn_ops.scratch_shapes(33, 70_000, 10, 132)
    assert s == {"part": ((33, 132, 10), torch.int64),
                 "ticket": ((3,), torch.int32)}
    s = knn_ops.scratch_shapes(16, 70_000, 200, 132)
    assert s["keys"] == ((16, 70_000), torch.int64)
    assert s["ghist"] == ((16, knn_ops.HIST_BINS), torch.int32)
    assert s["ghist2"] == ((16, knn_ops.REFINE_LEVELS, knn_ops.REFINE_BINS),
                           torch.int32)
    assert s["cand"] == ((16, 4096), torch.int64)
    assert s["ccount"][0] == s["overflow"][0] == (16,)
    assert knn_ops.candidate_cap(70_000, 2048) == 8192
    assert knn_ops.candidate_cap(3000, 1024) == 3000


def test_knn_grid_limits_are_checked():
    knn_ops.check_limits(65_535, 70_000, 200)
    knn_ops.check_limits(1_000_000, 70_000, 10)     # 1D grid
    with pytest.raises(ValueError, match="grid rows"):
        knn_ops.check_limits(65_536, 70_000, 200)
    with pytest.raises(ValueError, match="too large"):
        knn_ops.check_limits(1, 2**31, 10)


def test_knn_ticket_counter_is_allocated_once_per_stream(monkeypatch):
    calls = []
    monkeypatch.setattr(knn_ops, "_tickets", {})
    monkeypatch.setattr(knn_ops._build, "stream_ptr", lambda dev: 7)
    real = torch.zeros
    monkeypatch.setattr(knn_ops.torch, "zeros",
                        lambda *a, **kw: calls.append(a) or real(
                            *a, **{**kw, "device": "cpu"}))
    dev = torch.device("cpu")
    t1 = knn_ops._ticket(dev, 3)
    t2 = knn_ops._ticket(dev, 5)
    assert t1 is t2 and len(calls) == 1 and t1.numel() >= 64
    assert int(t1.sum()) == 0


@pytest.mark.parametrize("P,L,MB,m,nbits,kk,fits", [
    (8, 400, 64, 64, 8, 800, True),       # the serving shape
    (8, 400, 64, 64, 8, 2048, True),
    (8, 400, 64, 64, 8, 2049, False),     # kk above the fused limit
    (64, 400, 64, 64, 8, 800, False),     # nprobe near C: keys overflow
    (48, 400, 32, 64, 4, 800, True),     # nbits 4: a 4 KB table
    (24, 48, 16, 16, 8, 100, True),       # nprobe = C of a small index
    (8, 401, 2, 2, 8, 800, False),        # MB L not a multiple of 4
])
def test_ivfpq_fused_path_chosen_by_shape(P, L, MB, m, nbits, kk, fits):
    assert ivf_ops.fused_fits(m, nbits, MB, L, P, kk) == fits
    if kk <= ivf_ops.FUSED_KMAX and (MB * L) % 4 == 0:
        assert fits == (ivf_ops.fused_smem_bytes(m, nbits, MB, L, P, kk)
                        <= ivf_ops.FUSED_SMEM_MAX)


def test_ivfpq_fused_smem_at_the_serving_shape_lets_two_blocks_share_an_sm():
    """64 KB table, 25.6 KB of codes (the leader's keys in their place),
    3.2 KB of keys: two blocks an SM, so 16 queries' clusters fit one
    wave of 132 SMs."""
    b = ivf_ops.fused_smem_bytes(64, 8, 64, 400, 8, 800)
    assert b == 65536 + 25600 + 3216
    assert 2 * (b + 1024) <= 228 * 1024


@pytest.mark.parametrize("L,P,kk", [(48, 4, 2049), (4000, 24, 100)])
def test_ivfpq_fused_launch_refuses_shapes_that_do_not_fit(L, P, kk):
    """The shape picks the path; the fused launch is refused before any
    CUDA work where its limits do not hold: kk above 2,048, or nprobe = C
    whose keys (24 x 4,000 x 8 bytes) exceed a block's shared memory."""
    idx, m = _pq_index(8, L=L)
    q = torch.from_numpy(_unit(np.ones((2, 64))))
    probe = ivf_probe(q, idx["centroids"], P)
    args = (q, probe, idx["codes_cm"], idx["ids_cm"], idx["inv_cm"],
            idx["anchors"], idx["codebooks"], kk)
    assert not ivf_ops.fused_fits(m, 8, idx["codes_cm"].shape[1], L, P, kk)
    with pytest.raises(ValueError, match="fused path"):
        ivf_ops._adc_cuda(*args, m=m, nbits=8, fused=True)
    # a CPU tensor runs the plain version whatever the shape
    out = ivf_ops.ivfpq_adc(*args, m=m, nbits=8)
    ref = ivfpq_adc_plain(*args, m, 8)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
