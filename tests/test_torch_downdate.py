"""The schedule of the Cholesky downdate kernel (``kernels/linalg/csrc/
chol_downdate.cu``), proved on the CPU, where the kernel cannot run.

``_kernel_model`` is a float64 plain-PyTorch model of the kernel's order:
warps take (row tile I, column tile K) work items from a ticket counter in
column-major order; in an item, lane k holds column k of the tile (slot s
is row s) and applies sweep t - k at step t, w passing one lane on each
step; the diagonal item keeps each lane's diagonal entry apart, computes
each rotation once and publishes it to R by step; W^T is updated in place,
tile by tile, from item (I, K - 1) to item (I, K + 1). Every value another
item reads carries the kernel's tag (W: the writer's column tile plus one,
0 for the input; R: the step plus one, 0 before it is written), and a read
waits until its words show the tag it expects. A seeded scheduler
interleaves a few warps step by step, taking only those whose reads can
go ahead: an expected tag that let a read run early would feed it stale W
or an unwritten (NaN) rotation, and an order that could deadlock would
leave no warp to run. The model must be bitwise ``ref.chol_downdate``,
whose sweeps are held within 1e-12 of the reference's
``chol_update_rank(sign=-1.0)`` at the same sizes. The model divides with
``/`` where the kernel takes its branch-free quotient, which is the same
correctly rounded quotient: ``_model_quotient`` computes that quotient
exactly (``fractions.Fraction``, each FMA rounded once) on hard operands
and holds it against IEEE division, and ``quotient_groups`` gives the card
test (``tests/test_torch_cuda.py``) the same operands for the kernel's own
code.

Only ``test_plain_sweeps_match_the_reference`` imports JAX, so that the card
test, on a machine without it, can import the operands from here.
"""
import random
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core import linalg
from repro_torch.kernels.linalg import ops as linalg_ops, ref as linalg_ref


def _inputs(n, b, zero_cols=(), seed=0, dtype=torch.float64):
    """L1 = chol(L0 L0ᵀ + W Wᵀ) from the QR of its root, and W: downdating
    L1 by W gives back L0 (the card tests' inputs)."""
    rng = np.random.default_rng(seed)
    L0 = np.tril(rng.normal(size=(n, n)) * 0.1, -1) \
        + np.diag(1.0 + rng.random(n))
    W = rng.normal(size=(n, b)) * 0.5 / np.sqrt(max(b, 1))
    W[:, list(zero_cols)] = 0.0
    L0, W = (torch.tensor(a, dtype=dtype) for a in (L0, W))
    return L0, linalg.chol_from_root(L0, W), W


def _kernel_model(L, W, tile, warps, seed):
    """The downdate in the kernel's order, ``warps`` warps interleaved by a
    seeded scheduler (see the module docstring)."""
    n, b = W.shape
    nt = -(-n // tile)
    steps = b + tile - 1
    dt = L.dtype
    tiny = torch.finfo(dt).tiny
    out = L.clone()
    Wt = torch.zeros((b, tile * nt), dtype=dt)        # values, and their tags
    Wt[:, :n] = W.mT
    Wtag = torch.zeros((b, tile * nt), dtype=torch.long)
    R = torch.full((nt, steps, tile, 2), float("nan"), dtype=dt)
    Rtag = torch.zeros((nt, steps, tile), dtype=torch.long)
    order = [(I, K) for K in range(nt) for I in range(K, nt)]
    lanes = torch.arange(tile)

    def apply(lv, wv, c, s, act):
        num = lv - s[:, None] * wv
        q = num / c[:, None]
        wn = c[:, None] * wv - s[:, None] * q
        lv[:] = torch.where(act[:, None], q, lv)
        wv[:] = torch.where(act[:, None], wn, wv)

    def item(I, K):
        diag = I == K
        r0 = tile * I
        cols = tile * K + lanes
        rows = (r0 + lanes)[None, :].expand(tile, tile)    # (lane, slot)
        ok = (rows < n) & (cols[:, None] < n)
        if diag:
            ok &= rows - r0 > lanes[:, None]
        lv = torch.where(ok, out[rows.clamp(max=n - 1),
                                 cols.clamp(max=n - 1)[:, None]], 0.0)
        live = cols < n
        ldg = torch.where(live, out[cols.clamp(max=n - 1),
                                    cols.clamp(max=n - 1)], 0.0)
        wv = torch.zeros((tile, tile), dtype=dt)
        wtag, otag = K, K + 1          # the W it takes in, the W it hands on
        xin = None
        for t in range(b + tile):
            if t < b:                  # this step's sweep, once handed on
                while not bool((Wtag[t, r0:r0 + tile] == wtag).all()):
                    yield False
                xin = Wt[t, r0:r0 + tile].clone()
            jo = t - tile
            if not diag and 0 <= jo < b:      # lane tile-1 hands on
                Wt[jo, r0:r0 + tile] = wv[tile - 1]
                Wtag[jo, r0:r0 + tile] = otag
                yield True                    # others may run on it
            if t == steps:
                break
            wv = torch.roll(wv, shifts=1, dims=0)
            wv[0] = xin
            j = t - lanes
            act = (j >= 0) & (j < b) & live
            if diag:
                wk = wv[lanes, lanes]
                r = torch.sqrt(torch.clamp(ldg * ldg - wk * wk, min=tiny))
                c, s = r / ldg, wk / ldg
                ldg = torch.where(act, r, ldg)
                R[K, t][act] = torch.stack([c, s], 1)[act]
                Rtag[K, t][act] = t + 1
                apply(lv, wv, c, s, act)
            else:
                while not bool((Rtag[K, t][act] == t + 1).all()):
                    yield False
                rt = R[K, t]
                apply(lv, wv, rt[:, 0], rt[:, 1], act)
            yield True
        out[rows[ok], cols[:, None].expand_as(rows)[ok]] = lv[ok]
        if diag:
            out[cols[live], cols[live]] = ldg[live]

    def warp(tickets):
        for I, K in tickets:
            yield from item(I, K)
            yield True                # its last hand-on is out

    tickets = iter(order)
    live = [warp(tickets) for _ in range(warps)]
    stuck = set()                 # warps that waited since the last progress
    rng = random.Random(seed)
    while live:
        g = rng.choice(live)
        try:
            ran = next(g)
        except StopIteration:
            live.remove(g)
            ran = True
        if ran:
            stuck.clear()
        else:
            stuck.add(id(g))
            assert len(stuck) < len(live), "no warp can run: deadlock"
    return out


# (n, b, tile, zero columns, warps): tiles that divide n and tiles that do
# not, the kernel's 32 x 32 tiles at their edges, b > n, b = 1, n = 1 and
# zero columns
CASES = [
    (16, 8, 4, (), 3),
    (18, 7, 4, (), 3),
    (130, 40, 32, (), 4),
    (64, 65, 32, (), 5),
    (31, 7, 32, (), 2),
    (33, 9, 32, (), 2),
    (40, 1, 8, (), 2),
    (1, 5, 4, (), 2),
    (24, 6, 8, (0, 3, 5), 3),
    (10, 37, 4, (), 1),
]


@pytest.mark.parametrize("n,b,tile,zero_cols,warps", CASES)
def test_kernel_schedule_is_the_plain_sweeps_bit_for_bit(n, b, tile,
                                                         zero_cols, warps):
    L0, L1, W = _inputs(n, b, zero_cols)
    want = linalg_ref.chol_downdate(L1, W)
    for seed in (0, 1):
        got = _kernel_model(L1, W, tile, warps, seed)
        assert torch.equal(got, want)
    assert float((want - L0).abs().max()) < 1e-12
    assert torch.equal(want.triu(1), L1.triu(1))


def test_kernel_schedule_in_float32():
    """The same order in float32 (the kernel's other instance)."""
    _, L1, W = _inputs(70, 20, dtype=torch.float32)
    assert torch.equal(_kernel_model(L1, W, 32, 3, 0),
                       linalg_ref.chol_downdate(L1, W))


def _ticket(x, nt, probe):
    """The kernel's ticket -> work item (I, K) (``downdate_kernel``)."""
    if probe:
        return (x + 1) // 2, x // 2
    K = 0
    while x >= nt - K:
        x -= nt - K
        K += 1
    return K + x, K


@pytest.mark.parametrize("nt", [1, 2, 5, 64])
def test_ticket_order_is_topological(nt):
    """The kernel hands out every item (I, K), K <= I, once, column-major
    with the diagonal first (the chain probe: (0, 0), (1, 0), (1, 1), ...),
    each after the items it waits on: (I, K - 1) for W and (K, K) for R.
    So the lowest unfinished ticket can always run: no deadlock."""
    for probe, count in ((False, nt * (nt + 1) // 2), (True, 2 * nt - 1)):
        at = {_ticket(x, nt, probe): x for x in range(count)}
        assert len(at) == count
        assert all(0 <= K <= I < nt and (not probe or I - K <= 1)
                   for I, K in at)
        for (I, K), x in at.items():
            if not probe or I == K:
                assert K == 0 or at[(I, K - 1)] < x
            assert I == K or at[(K, K)] < x
    assert [_ticket(x, nt, False) for x in range(nt * (nt + 1) // 2)] == \
        [(I, K) for K in range(nt) for I in range(K, nt)]


@pytest.mark.parametrize("n,b,zero_cols", sorted({c[:2] + c[3:4]
                                                  for c in CASES}))
def test_plain_sweeps_match_the_reference(n, b, zero_cols):
    """``ref.chol_downdate`` against the reference's
    ``chol_update_rank(sign=-1.0)`` under x64, within 1e-12."""
    import jax.numpy as jnp
    from repro.core import linalg as jlinalg
    _, L1, W = _inputs(n, b, zero_cols)
    want = jlinalg.chol_update_rank(jnp.asarray(L1.numpy()),
                                    jnp.asarray(W.numpy()), sign=-1.0)
    got = linalg_ref.chol_downdate(L1, W)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,b", [(40, 5), (1, 3), (3, 1), (1, 1), (64, 2)])
def test_tagged_words_hold_w(dtype, n, b):
    """The wrapper's Wᵀ in the kernel's tagged words: each 64-bit word a
    32-bit half of a value (a float's bits, or a double's low then high
    half) under tag 0, rows padded to whole row tiles with zeros."""
    W = torch.tensor(np.random.default_rng(n + b).normal(size=(n, b)),
                     dtype=dtype)
    rows = 32 * -(-n // 32)                  # n in whole 32-row tiles
    words = linalg_ops._tagged(W, rows).view(torch.int64)
    per = 2 if dtype == torch.float64 else 1
    assert words.shape == (b, rows, per, 1)
    words = words[..., 0]
    assert int((words >> 32).abs().max()) == 0          # every tag 0
    low = words & 0xFFFFFFFF
    if dtype == torch.float64:
        got = (low[..., 0] | (low[..., 1] << 32)).view(torch.float64)
    else:
        got = low[..., 0].to(torch.int32).view(torch.float32)
    assert torch.equal(got[:, :n], W.mT)
    assert not got[:, n:].any()


# --- the row update's quotient ------------------------------------------------
# The kernel divides a step's numerators a by its c as q0 = a y,
# q1 = q0 + (a - c q0) y, q = q1 + (a - c q1) y, each line FMAs rounded once,
# with y = 1/c correctly rounded, when c and every numerator of the step lie
# in [2^-E, 2^E) (E = 500 in float64, 40 in float32); a step with an operand
# outside that range divides with IEEE division.

# precision, least normal exponent, greatest exponent, E
_FORMATS = {np.float64: (53, -1022, 1023, 500), np.float32: (24, -126, 127, 40)}


def _round(x: Fraction, fmt) -> Fraction:
    """x rounded to the nearest value of ``fmt``, ties to even (subnormals
    included; no overflow in what is asked here)."""
    p, emin, emax, _ = _FORMATS[fmt]
    if x == 0:
        return Fraction(0)
    m = abs(x)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1                                   # 2^e <= m < 2^(e + 1)
    ulp = Fraction(2) ** (max(e, emin) - p + 1)
    k, rem = divmod(m, ulp)
    if 2 * rem > ulp or (2 * rem == ulp and k % 2):
        k += 1
    assert k * ulp < Fraction(2) ** (emax + 1)
    return k * ulp if x > 0 else -k * ulp


def _model_quotient(a, c, fmt):
    """(q0, q1, q) of the kernel's quotient of a by c, exactly."""
    A, C = Fraction(float(a)), Fraction(float(c))
    y = _round(1 / C, fmt)
    q0 = _round(A * y, fmt)
    q1 = _round(_round(A - C * q0, fmt) * y + q0, fmt)
    q = _round(_round(A - C * q1, fmt) * y + q1, fmt)
    return q0, q1, q


def _in_range(x, fmt) -> bool:
    """|x| in [2^-E, 2^E): the fast quotient's range."""
    E = _FORMATS[fmt][3]
    return bool(2.0 ** -E <= abs(float(x)) < 2.0 ** E)


def quotient_pairs(fmt, seed=0):
    """Hard operands (a, c) of ``fmt``, all in the fast quotient's range:
    quotients within a few 2^-p ulp of a midpoint between two neighbours
    (c odd with p bits, A = d / 2^(p+1) mod c, d = ±1, ±3: then a / c =
    k + 1/2 + d / 2c at the quotient's ulp), c at and near 1 and powers of
    two, operands at both ends of the range, and random ones; a of both
    signs."""
    p, _, _, E = _FORMATS[fmt]
    rng = random.Random(seed)
    exps = [-E, -E + 1, -E // 2, -1, 0, 1, E // 2, E - 2, E - 1]
    pairs = []

    def put(a, c):
        a, c = fmt(a), fmt(c)
        assert _in_range(a, fmt) and _in_range(c, fmt)
        pairs.append((a, c))

    inv = pow(2, p + 1)
    for i in range(160):
        while True:
            c_int = rng.randrange(2 ** (p - 1), 2 ** p) | 1
            d = (1, -1, 3, -3)[i % 4]
            a_int = d * pow(inv, -1, c_int) % c_int
            if a_int >= 2 ** (p - 1):
                break
        ea, ec = rng.choice(exps), rng.choice(exps)
        sign = -1 if i % 3 == 0 else 1
        put(sign * a_int * 2.0 ** (ea - p + 1), c_int * 2.0 ** (ec - p + 1))
    for k in (-E, -3, 0, 5, E - 1):
        two_k = fmt(2.0 ** k)
        for c in (two_k, np.nextafter(two_k, fmt(np.inf)),
                  np.nextafter(two_k, fmt(0))):
            if not _in_range(c, fmt):
                continue
            for _ in range(6):
                put(rng.randrange(2 ** (p - 1), 2 ** p)
                    * 2.0 ** (rng.choice(exps) - p + 1), c)
    lo, hi = fmt(2.0 ** -E), np.nextafter(fmt(2.0 ** E), fmt(0))
    edges = [lo, np.nextafter(lo, fmt(1)), hi, np.nextafter(hi, fmt(0)),
             fmt(1.5)]
    for a in edges:
        for c in edges:
            put(a, c)
            put(-a, c)
    for _ in range(100):
        put(rng.uniform(1, 2) * 2.0 ** rng.randrange(-E, E),
            rng.uniform(1, 2) * 2.0 ** rng.randrange(-E, E))
    return pairs


@pytest.mark.parametrize("fmt", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_branch_free_quotient_is_ieee_division(fmt):
    """The kernel's quotient, computed exactly as its FMAs round, is the
    IEEE quotient bit for bit on every hard operand pair in its range
    (Markstein's theorem), and the corrections matter there: the bare
    product a y misses on many of them."""
    pairs = quotient_pairs(fmt)
    q0_off = 0
    for a, c in pairs:
        want = Fraction(float(a / c))            # numpy's IEEE division
        assert _round(Fraction(float(a)) / Fraction(float(c)), fmt) == want
        q0, _, q = _model_quotient(a, c, fmt)
        assert q == want, (a, c)
        q0_off += q0 != want
    assert q0_off > len(pairs) // 10


def quotient_groups(fmt, seed=0):
    """The card test's operands for the kernel's quotient probe: groups of
    32 numerators over one c, a mask of the slots that are rows, and
    whether the step must take the fast quotient. One group for each pair
    of ``quotient_pairs`` (its a in a slot, the other slots other pairs'
    a); then each edge value (both ends of the range and just outside,
    zeros, subnormals, the least normal, infinities, NaN) in slots 0, 17
    and 31 of a group, with the slot counted and then masked out, and as
    the group's c. Returns a (G, 32), c (G,), mask (G,) int32 and fast (G,)
    bool, numpy."""
    p, _, _, E = _FORMATS[fmt]
    pairs = quotient_pairs(fmt, seed)
    pool = np.array([a for a, _ in pairs], dtype=fmt)
    rng = np.random.default_rng(seed)
    groups, cs, masks, fast = [], [], [], []

    def group(slots, c, mask, want_fast):
        groups.append(slots)
        cs.append(c)
        masks.append(mask)
        fast.append(want_fast)

    full = -1                                    # all 32 bits, as int32
    for i, (a, c) in enumerate(pairs):
        slots = rng.choice(pool, 32)
        slots[i % 32] = a
        group(slots, c, full, True)
    lo, hi = fmt(2.0 ** -E), fmt(2.0 ** E)
    info = np.finfo(fmt)
    edges = [lo, np.nextafter(lo, fmt(0)), np.nextafter(hi, fmt(0)), hi,
             fmt(0), -fmt(0), info.smallest_subnormal, info.tiny, info.max,
             fmt(np.inf), fmt(-np.inf), fmt(np.nan)]
    edges += [-e for e in edges[:4]]
    for v in edges:
        for s in (0, 17, 31):
            slots = rng.choice(pool, 32)
            slots[s] = v
            group(slots, fmt(1.5), full, _in_range(v, fmt))
            bit = np.int64(1) << s
            group(slots.copy(), fmt(1.5),
                  np.int64(0xFFFFFFFF ^ bit).astype(np.uint32).view(np.int32),
                  True)
        group(rng.choice(pool, 32), v, full, _in_range(v, fmt))
    return (np.stack(groups).astype(fmt), np.array(cs, dtype=fmt),
            np.array(masks, dtype=np.int64).astype(np.uint32).view(np.int32),
            np.array(fast))
