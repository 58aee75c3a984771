"""Port memory read (otvm_tpu_torch.kernels.memory_attn).

On the CPU: the plain version against the JAX package's XLA path and its
Pallas kernel (interpret mode), fp32, at the JAX tests' shapes; the
kernels' split arithmetic (plain partials merged by `combine_plain`, the
plain version of the kernels' merge) against the plain read; the launch
geometry's coverage, split rule and merge under given max-active-cluster
tables (`python -m pytest tests/test_torch_memory_attn.py -k "geometry or
split_rule or forced"`); and the fp32 kernel's 3xTF32 arithmetic,
emulated, against the plain read.  On a card: the CUDA kernels, split 1
to 8 ways and merged in a cluster or through L2, against their plain
versions, by the
norm-relative error that a lower-precision control fails (skipped
without a card).  The read's
gradient: the autograd Function's plain backward against the JAX package's
`_flash_bwd` on the CPU, and against autograd through the plain read on the
CPU and on a card.  JAX is
imported by the tests that use it, so the card's tests run where JAX is
absent: `python -m pytest --noconftest -m cuda tests/test_torch_memory_attn.py`."""
import numpy as np
import pytest
import torch

from otvm_tpu_torch.kernels import memory_attn as ma
from otvm_tpu_torch.tools.kernel_check import (GRAD_TOL, READ_TOL, control, plain_read_grads,
                                               rel_err)

# the JAX tests' shapes (tests/test_memory_attn_pallas.py): (hw, t, mask)
CASES = [(64, 2, None), (96, 3, [1, 1, 0]), (128, 5, [1, 0, 0, 0, 0]), (70, 3, None)]


def _inputs(b, hw, t, seed=0, ck=128, cv=512):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hw, ck).astype(np.float32),
            rng.randn(b, t, hw, ck).astype(np.float32),
            rng.randn(b, t, hw, cv).astype(np.float32))


def _mask(rows, b):
    return None if rows is None else np.tile(np.asarray(rows, bool)[None], (b, 1))


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from otvm_tpu.kernels.memory_attn import memory_read_pallas, memory_read_xla
    return jnp, memory_read_xla, memory_read_pallas


def _plain(q, k, v, m):
    return ma.memory_read_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                None if m is None else torch.from_numpy(m)).numpy()


@pytest.mark.parametrize("hw,t,rows", CASES)
def test_plain_matches_xla_and_pallas(jx, hw, t, rows):
    jnp, memory_read_xla, memory_read_pallas = jx
    q, k, v = _inputs(2, hw, t)
    m = _mask(rows, 2)
    jm = None if m is None else jnp.asarray(m)
    got = _plain(q, k, v, m)
    xla = np.asarray(memory_read_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))
    pallas = np.asarray(memory_read_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                           block_q=32, block_kv=64, interpret=True))
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rows", [[0, 0, 0], [0, 1, 0]])
def test_plain_matches_xla_empty_and_non_prefix_mask(jx, rows):
    """No valid slot: the uniform average (Pallas gives NaN there, so XLA
    only).  A non-prefix mask is the general [B, T] form."""
    jnp, memory_read_xla, _ = jx
    q, k, v = _inputs(2, 48, 3, seed=3)
    m = _mask(rows, 2)
    got = _plain(q, k, v, m)
    want = np.asarray(memory_read_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(m)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_plain_bf16_matches_xla(jx):
    jnp, memory_read_xla, _ = jx
    q, k, v = _inputs(1, 64, 2, seed=4)
    m = _mask([1, 1], 1)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = ma.memory_read_plain(bf(q), bf(k), bf(v), torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = memory_read_xla(jbf(q), jbf(k), jbf(v), jnp.asarray(m))
    # both round p and the output to bf16 (8 bits of mantissa) at
    # different points of their own softmax: a few bf16 ulps of |out| <= ~4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2, rtol=2e-2)


def test_wrapper_uses_plain_on_cpu():
    q, k, v = _inputs(1, 32, 2, seed=5)
    before = ma.launches
    got = ma.memory_read(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None)
    assert ma.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(q, k, v, None))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ma.memory_read_cuda(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))


@pytest.mark.parametrize("rows", [None, [[1, 0, 1], [0, 1, 1]]])
def test_vjp_plain_matches_flash_bwd(rows):
    """memory_read_vjp_plain against the JAX package's custom-VJP backward,
    called with its residuals, fp32: summation order only."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from otvm_tpu.kernels.memory_attn import _flash_bwd
    q, k, v = _inputs(2, 70, 3, seed=11)
    g = np.random.RandomState(12).randn(2, 70, 512).astype(np.float32)
    m = None if rows is None else np.asarray(rows, bool)
    want = _flash_bwd((jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       None if m is None else jnp.asarray(m)), jnp.asarray(g))
    got = ma.memory_read_vjp_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   None if m is None else torch.from_numpy(m), torch.from_numpy(g))
    for a, b in zip(got, want[:3]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)
    assert (want[3] is None) == (m is None)   # the mask gets no gradient


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memory_read_carries_a_gradient_on_cpu(dtype):
    """Inputs that require grad go through the autograd Function: its
    gradients are memory_read_vjp_plain's and agree with autograd through
    the plain read; other inputs take the direct call, with no graph."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(2, 70, 2, seed=13))
    g = torch.from_numpy(np.random.RandomState(14).randn(2, 70, 512).astype(np.float32)).to(dt)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ma.memory_read(*leaves)
    assert out.requires_grad and out.grad_fn is not None
    assert torch.equal(out, ma.memory_read_plain(q, k, v))
    got = torch.autograd.grad(out, leaves, g)
    for a, b, c, d in zip(got, ma.memory_read_vjp_plain(q, k, v, None, g),
                          plain_read_grads(q, k, v, None, g),
                          plain_read_grads(control(q), control(k), control(v), None, g)):
        assert a.dtype == dt and torch.equal(a, b)
        assert rel_err(a, c) <= GRAD_TOL[dt] < rel_err(d, c)
    assert ma.memory_read(q, k, v).grad_fn is None
    with torch.no_grad():
        assert ma.memory_read(*leaves).grad_fn is None


# (b, hw, t, per-row masks, splits): ragged query tiles (70), splits that
# straddle slots (70, 48), empty, non-prefix and per-row masks
SPLIT_CASES = [
    (2, 70, 3, [[1, 0, 1], [0, 1, 1]], 3),
    (1, 48, 3, [[0, 0, 0]], 2),
    (1, 100, 4, [[0, 1, 0, 1]], 5),
    (2, 130, 2, [[1, 1], [1, 0]], 1),
    (1, 64, 6, [[1, 0, 0, 0, 0, 0]], 4),   # splits with no live position
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hw,t,rows,splits", SPLIT_CASES)
def test_split_partials_combine_to_plain(dtype, b, hw, t, rows, splits):
    """Merging the per-split partials (m, l, acc) gives the unsplit read."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(b, hw, t, seed=7))
    m = torch.tensor(rows, dtype=torch.bool)
    acc, ml = ma.memory_read_partials_plain(q, k, v, m, splits)
    assert acc.shape == (splits, b, hw, 512) and ml.shape == (splits, b, hw, 2)
    got = ma.combine_plain(acc, ml, dt)
    want = ma.memory_read_plain(q, k, v, m)
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    if dt == torch.float32:     # summation order only
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=1e-5)
    else:   # p rounded against each split's own max, not after normalising
        assert rel_err(got, want) <= READ_TOL[dt]
        assert rel_err(ma.memory_read_plain(control(q), control(k), control(v), m), want) \
            > READ_TOL[dt]


# {n: clusters of n blocks a card holds at once; 1: blocks}: for one block
# per SM on 132 SMs in GPCs of 18, 18 and six of 16 SMs (a cluster lies in
# one GPC); and as cudaOccupancyMaxActiveClusters gives it for every read
# kernel on an H100 80GB HBM3, where 8-block clusters do not fit 16 at once
# and 4-block ones not 32 (chip_smoke.py phase 2 prints it).
GPC_TABLE = {s: sum(g // s for g in (18, 18, 16, 16, 16, 16, 16, 16)) for s in range(1, 9)}
H100_TABLE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def _splits_ok(dt, b, hw, t, cv, table, splits):
    """The split rule's conditions: at most 8, at least MIN_TILES_PER_SPLIT
    of the dtype's own K/V tiles a split, the whole grid on the card at
    once."""
    tiles = -(-hw // ma.query_tile(dt)) * (cv // ma.value_tile(cv)) * b
    bank = -(-t * hw // ma.tile_positions(dt))
    return (splits <= 8 and bank >= splits * ma.MIN_TILES_PER_SPLIT
            and tiles * splits <= table[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hw,t,ck,cv,rows", [
    (1, 1024, 6, 128, 512, [1, 1, 1, 1, 1, 0]),       # 512p, count 5
    (1, 1024, 6, 128, 512, [1, 0, 0, 0, 0, 0]),       # 512p, count 1
    (1, 8160, 3, 128, 512, [1, 1, 0]),                # 1088x1920, count 2
    (2, 70, 3, 128, 512, [0, 1, 0]),                  # ragged, non-prefix
    (1, 48, 3, 128, 384, [0, 0, 0]),                  # HW < 64, empty, Cv % 256 != 0
    (2, 64, 4, 32, 128, [1, 1, 0, 1]),                # the scale-4 model's widths
    (4, 400, 1, 128, 512, [1]),                       # the training shapes, T=1
    (4, 400, 2, 128, 512, [1, 1]),                    # and T=2
])
def test_launch_geometry_covers_each_output_and_position_once(dtype, b, hw, t, ck, cv, rows):
    """A launch's blocks cover every (query row, value column) once; the
    chosen split count is the largest that meets the split rule (at most 8,
    at least MIN_TILES_PER_SPLIT of the dtype's own K/V tiles a split, the
    whole grid on the card at once), merged in one cluster a tile where the
    card holds those clusters at once and through L2 otherwise, unless the
    largest that merges in a cluster is within L2_MERGE_TILES; a forced
    one is taken as it is; the plain split partials (the merge's input) in
    the dtype read every live position once.  The kernels' own K/V
    coverage is held by the card tests (splits 1 to 8)."""
    dt = getattr(torch, dtype)
    for table in (GPC_TABLE, H100_TABLE):
        for splits in (None, 1, 3, 8):
            q_tiles, cv_tiles, n_split, blocks = ma.launch_geometry(b, hw, t, cv, dt, table,
                                                                    _splits=splits)
            cvt = ma.value_tile(cv)
            bq = ma.query_tile(dt)
            assert cv_tiles * cvt == cv and q_tiles * bq >= hw > (q_tiles - 1) * bq
            tiles = q_tiles * cv_tiles * b
            assert blocks in (1, n_split)
            if splits is None:
                # the most splits, or the most that merge in one cluster a
                # tile where more cut fewer than L2_MERGE_TILES off the
                # longest split
                ok = [s for s in range(2, 17) if _splits_ok(dt, b, hw, t, cv, table, s)]
                most = max(ok, default=1)
                one = max((s for s in ok if tiles <= table[s]), default=1)
                longest = lambda s: -(-t * hw // ma.tile_positions(dt) // s)
                cut = longest(one) - longest(most) >= ma.L2_MERGE_TILES[dt]
                assert n_split == (most if cut else one)
            else:
                assert n_split == splits
            if n_split > 1:     # one cluster a tile where they fit at once, else L2
                in_clusters = tiles <= table[n_split] or tiles * n_split > table[1]
                assert (blocks == n_split) == in_clusters
        # one query row, scores 0; V = (1, position in base 64): digits
        # below 64 are exact in bf16, and the merged partials' sums
        # (integers below 2^24, exact in fp32) give the count and three
        # sums of the positions read
        pos = torch.arange(t * hw).reshape(1, t, hw, 1).expand(b, t, hw, 1)
        v = torch.cat([torch.ones_like(pos), pos % 64, pos // 64 % 64, pos // 4096], dim=-1)
        acc, ml = ma.memory_read_partials_plain(
            torch.zeros(b, 1, ck, dtype=dt), torch.zeros(b, t, hw, ck, dtype=dt), v.to(dt),
            torch.tensor(rows, dtype=torch.bool).expand(b, t), n_split)
        valid = np.repeat(np.asarray(rows, bool), hw) if any(rows) else np.ones(t * hw, bool)
        live = np.flatnonzero(valid)
        want = [len(live), (live % 64).sum(), (live // 64 % 64).sum(), (live // 4096).sum()]
        np.testing.assert_array_equal(acc.sum(dim=0)[:, 0].numpy(), np.tile([want], (b, 1)))
        np.testing.assert_array_equal(ml[..., 1].sum(dim=0).numpy(), np.full((b, 1), len(live)))


def test_tf32_round_is_cvt_rna():
    """TF32 at 10 mantissa bits as the fp32 kernel's operands reach the
    tensor cores: wgmma reads an fp32 operand's 19 high bits, so the split
    rounds toward zero, on either sign, where cvt.rna.tf32.f32 would round
    to nearest; hi + lo then holds x to 2^-20 |x|.  The name predates the
    truncating split: the test checks round toward zero, not cvt.rna."""
    u = 2.0 ** -10                                    # TF32's ulp at 1
    x = torch.tensor([1 + u / 2, 1 + u / 4, -(1 + u / 2), 1 + 1.5 * u, 1 + 0.75 * u, 3.0,
                      1 + u - 2.0 ** -23, 0.0])
    want = [1.0, 1.0, -1.0, 1 + u, 1.0, 3.0, 1.0, 0.0]
    assert ma.tf32_round(x).tolist() == want
    r = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    hi = ma.tf32_round(r)
    bits = hi.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()
    assert ((hi - r).abs() < r.abs() * 2.0 ** -10).all() and (hi.abs() <= r.abs()).all()
    lo = ma.tf32_round(r - hi)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -20).all()


# (b, hw, t, per-row masks): 512p count 5, HW=70 with per-row masks, count 0
TF32_CASES = [(1, 1024, 6, [[1, 1, 1, 1, 1, 0]]),
              (2, 70, 3, [[1, 0, 1], [0, 1, 1]]),
              (1, 1024, 6, [[0, 0, 0, 0, 0, 0]]),
              (4, 400, 1, [[1]] * 4),                   # the training shapes, T=1
              (4, 400, 2, [[1, 1], [1, 0], [0, 1], [1, 1]])]


@pytest.mark.parametrize("b,hw,t,rows", TF32_CASES)
def test_3xtf32_read_is_within_fp32_tolerance_and_1xtf32_is_not(b, hw, t, rows):
    """The fp32 kernel's arithmetic, emulated: both products with operands
    split into TF32 halves (3xTF32) stay within READ_TOL[fp32] of the plain
    read; plain TF32 (hi * hi alone) does not, so the card's check tells a
    kernel that dropped the small terms from a sound one."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, hw, t, seed=10))
    m = torch.tensor(rows, dtype=torch.bool)
    want = ma.memory_read_plain(q, k, v, m)
    got3 = ma.memory_read_tf32_plain(q, k, v, m, passes=3)
    got1 = ma.memory_read_tf32_plain(q, k, v, m, passes=1)
    assert got3.dtype == torch.float32 and torch.isfinite(got3).all()
    assert rel_err(got3, want) <= READ_TOL[torch.float32] < rel_err(got1, want)


def _cuda_ready():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype,b,hw,t,table,want", [
    ("bfloat16", 1, 1024, 6, GPC_TABLE, "8x8"),   # 512p: 16 clusters of 8 at once
    ("float32", 1, 1024, 6, GPC_TABLE, "4x4"),    # fp32's 64-row tiles: 32 tiles, 4 splits
    ("bfloat16", 1, 1024, 6, H100_TABLE, "8x1"),  # the H100 holds 15: the L2 merge
    ("float32", 1, 1024, 6, H100_TABLE, "4x1"),   # fill the card; 32 clusters of 4 fit on
    ("float32", 4, 400, 1, GPC_TABLE, "2x2"),     # the GPC table, 30 on the H100; training:
    ("float32", 4, 400, 2, GPC_TABLE, "2x2"),     # 56 tiles, 2 splits (13 and 25 fp32 K/V
    ("float32", 4, 400, 1, H100_TABLE, "2x2"),    # tiles), 66 clusters of 2 on either card
    ("float32", 4, 400, 2, H100_TABLE, "2x2"),
    ("bfloat16", 4, 400, 1, H100_TABLE, "3x3"),   # 7 bf16 tiles: 3 splits, 32 clusters of 3
    ("bfloat16", 4, 400, 2, H100_TABLE, "3x3"),   # 13 bf16 tiles: 4 cuts only 1 off 5
    ("bfloat16", 1, 8160, 3, GPC_TABLE, "1x1"),   # 1088x1920: 128 blocks fill the card
    ("float32", 1, 8160, 3, H100_TABLE, "1x1"),
])
def test_split_rule_counts_own_tiles_in_one_wave(dtype, b, hw, t, table, want):
    """The split count and how it merges ("splits x blocks a cluster") at
    the stream's and the training shapes, under a card's table: each
    dtype's own K/V tiles (bf16 64 positions, fp32 32) at least
    MIN_TILES_PER_SPLIT a split, the whole grid on the card at once, one
    cluster a tile where they fit at once, else through L2, unless fewer
    splits in one cluster leave the longest split within L2_MERGE_TILES."""
    dt = getattr(torch, dtype)
    got = ma.launch_geometry(b, hw, t, 512, dt, table)[2:]
    assert "x".join(map(str, got)) == want


def test_split_rule_unit_and_cap():
    """fp32 counts the bank in 32-position tiles, bf16 in 64-position ones;
    no split count passes 8, however large the bank and the card."""
    assert (ma.tile_positions(torch.bfloat16), ma.tile_positions(torch.float32)) == (64, 32)
    roomy = {s: 10 ** 6 for s in range(1, 17)}
    hw = 32 * ma.MIN_TILES_PER_SPLIT                  # T=3: 3 N fp32 tiles, 1.5 N bf16 ones
    assert ma.launch_geometry(1, hw, 3, 512, torch.float32, roomy)[2] == 3
    assert ma.launch_geometry(1, hw, 3, 512, torch.bfloat16, roomy)[2] == 1
    for dt in (torch.float32, torch.bfloat16):
        assert ma.launch_geometry(1, hw, 256, 512, dt, roomy)[2] == 8


@pytest.mark.parametrize("splits", [0, 9, 16])
def test_forced_splits_outside_a_cluster_raise(splits):
    with pytest.raises(ValueError, match="1 to 8"):
        ma.launch_geometry(1, 1024, 6, 512, torch.bfloat16, GPC_TABLE, _splits=splits)


def test_forced_splits_that_no_card_cluster_holds_raise():
    """A forced split count takes one cluster a tile where the card holds
    them at once, else the L2 merge where it holds the grid at once, else
    clusters in more than one wave; it is refused where the card holds no
    cluster of its size, where a forced cluster size is neither 1 nor the
    splits, and where a forced L2 merge's grid does not fit at once.  1
    (no cluster) is always taken."""
    table = {**H100_TABLE, 8: 0}
    with pytest.raises(ValueError, match="no cluster of 8"):
        ma.launch_geometry(1, 1024, 6, 512, torch.float32, table, _splits=8, _cluster=8)
    with pytest.raises(ValueError, match="no cluster of 4"):
        ma.launch_geometry(1, 1024, 6, 512, torch.float32, table, _splits=8, _cluster=4)
    with pytest.raises(ValueError, match="on the card at once"):
        ma.launch_geometry(1, 8160, 3, 512, torch.float32, table, _splits=2, _cluster=1)
    bf16, fp32 = torch.bfloat16, torch.float32
    # 512p: bf16's 128-row tiles make 16 output tiles, fp32's 64-row ones 32
    assert ma.launch_geometry(1, 1024, 6, 512, bf16, table, _splits=8)[2:] == (8, 1)
    assert ma.launch_geometry(1, 1024, 6, 512, bf16, table, _splits=6)[2:] == (6, 6)
    assert ma.launch_geometry(1, 1024, 6, 512, bf16, table, _splits=6, _cluster=1)[2:] == (6, 1)
    assert ma.launch_geometry(1, 1024, 6, 512, fp32, table, _splits=4)[2:] == (4, 1)
    assert ma.launch_geometry(1, 1024, 6, 512, fp32, table, _splits=3)[2:] == (3, 3)
    with pytest.raises(ValueError, match="on the card at once"):
        ma.launch_geometry(1, 1024, 6, 512, fp32, table, _splits=8, _cluster=1)
    assert ma.launch_geometry(1, 8160, 3, 512, fp32, table,
                              _splits=2)[2:] == (2, 2)              # 256 x 2 > 132: two waves
    assert ma.launch_geometry(1, 1024, 6, 512, fp32, {}, _splits=1)[2:] == (1, 1)
    assert ma.launch_geometry(1, 1024, 6, 512, bf16, table)[2:] == (8, 1)
    assert ma.launch_geometry(1, 1024, 6, 512, fp32, table)[2:] == (4, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,splits,cluster", [
    (d, s, c) for d in ("float32", "bfloat16")
    for s, c in ((None, None), (1, None), (2, None), (3, None), (4, None), (5, None), (8, None),
                 (8, 8), (4, 4), (8, 1), (6, 1), (4, 1), (3, 1), (2, 1))])
@pytest.mark.parametrize("b,hw,t,rows,ck,cv", [
    (1, 1024, 6, [1, 1, 1, 1, 1, 0], 128, 512), (1, 1024, 6, [1, 0, 0, 0, 0, 0], 128, 512),
    (2, 70, 3, [1, 0, 1], 128, 512), (1, 64, 3, [0, 0, 0], 128, 512),
    (2, 70, 3, [[1, 0, 1], [0, 1, 1]], 128, 512),     # per-row masks, ragged, straddling
    (1, 8160, 3, [1, 1, 0], 128, 512),                # 1088x1920, count 2
    (1, 8160, 6, [1, 1, 1, 1, 1, 0], 128, 512),       # and count 5 of 6
    (4, 400, 1, [1], 128, 512),                       # the training shapes, T=1
    (4, 400, 2, [[1, 1], [1, 0], [0, 1], [1, 1]], 128, 512),   # and T=2, per-row masks
    (1, 48, 3, [0, 1, 0], 128, 512),                  # HW < 64, non-prefix
    (2, 64, 4, [[1, 1, 0, 0], [0, 0, 0, 1]], 32, 128),  # the scale-4 model's widths
    (1, 100, 2, [1, 1], 128, 384),                    # Cv not a multiple of 256
])
def test_kernel_matches_plain_on_cuda(request, dtype, splits, cluster, b, hw, t, rows, ck, cv):
    """One launch per read; a split one merges in the kernel: in one
    cluster a tile (which traps if a block's cluster rank is not its
    split), or, with cluster 1, through L2 after a barrier of the tile's
    blocks (then twice in a row: the barrier's counters must be left fit
    for the next launch), which is refused where the grid does not fit on
    the card at once.  Splits 2 to 8 cover empty splits (HW 48 and 64),
    ragged query tiles (HW 70, 100), Ck=32 (whose merge tile grows the
    shared memory), Cv=384 (128-column value tiles) and B=2."""
    _cuda_ready()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt)
               for a in _inputs(b, hw, t, seed=6, ck=ck, cv=cv))
    m = np.asarray(rows, bool)
    m = torch.from_numpy(np.tile(m[None], (b, 1)) if m.ndim == 1 else m).cuda()
    table = ma.max_active_clusters(dt, ck, cv)
    tiles = -(-hw // ma.query_tile(dt)) * (cv // ma.value_tile(cv)) * b
    if cluster == 1 and tiles * splits > table[1]:
        with pytest.raises(ValueError, match="on the card at once"):
            ma.memory_read_cuda(q, k, v, m, _splits=splits, _cluster=cluster)
        return
    n_split, blocks = ma.launch_geometry(b, hw, t, cv, dt, table, _splits=splits,
                                         _cluster=cluster)[2:]
    before = ma.launches, ma.cluster_launches, ma.l2_merge_launches
    got = ma.memory_read_cuda(q, k, v, m, _splits=splits, _cluster=cluster)
    torch.cuda.synchronize()
    assert (ma.launches, ma.cluster_launches, ma.l2_merge_launches) == (
        before[0] + 1, before[1] + (blocks > 1), before[2] + (n_split > blocks))
    request.node.user_properties += [("splits", n_split), ("blocks", blocks)]
    if n_split > blocks:
        again = ma.memory_read_cuda(q, k, v, m, _splits=splits, _cluster=cluster)
        assert torch.equal(again, got), "a second launch on the same workspace differs"
    want = ma.memory_read_plain(q, k, v, m)
    assert torch.isfinite(got.float()).all()
    # the same read on inputs of a narrower type fails the check
    rel, rel_ctl = rel_err(got, want), rel_err(
        ma.memory_read_plain(control(q), control(k), control(v), m), want)
    request.node.user_properties += [("rel_err", rel), ("control_rel_err", rel_ctl)]
    assert rel <= READ_TOL[dt] < rel_ctl


@pytest.mark.cuda
def test_kernels_run_on_a_card_that_is_not_current():
    """Tensors on the second card, the first current: the wrappers launch
    on the tensors' card (bf16 with a split, and fp32)."""
    _cuda_ready()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    mask = torch.tensor([[True, True, False]], device="cuda:1")
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(a).to("cuda:1", dt) for a in _inputs(1, 1024, 3, seed=9))
        before = ma.launches
        got = ma.memory_read_cuda(q, k, v, mask)
        assert got.device == q.device and ma.launches == before + 1
        torch.cuda.synchronize(q.device)
        assert rel_err(got, ma.memory_read_plain(q, k, v, mask)) <= READ_TOL[dt]
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 2])
def test_memory_read_carries_a_gradient_on_cuda(request, dtype, t):
    """At the training shapes (B 4, HW 400 of a 320x320 crop, T 1 and 2):
    memory_read on inputs that require grad launches the kernel once and
    returns a tensor with a grad_fn; its output and gradients agree with
    autograd through the plain read, and a lower-precision control does
    not.  memory_read_cuda itself raises on such inputs."""
    _cuda_ready()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in _inputs(4, 400, t, seed=15))
    g = torch.from_numpy(np.random.RandomState(16).randn(4, 400, 512).astype(np.float32)
                         ).cuda().to(dt)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = ma.launches
    out = ma.memory_read(*leaves)
    assert ma.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert ma.launches == before + 1          # the backward launches no kernel
    assert rel_err(out, ma.memory_read_plain(q, k, v)) <= READ_TOL[dt]
    errs = []
    for a, want, ctl in zip(got, plain_read_grads(q, k, v, None, g),
                            plain_read_grads(control(q), control(k), control(v), None, g)):
        errs.append((rel_err(a, want), rel_err(ctl, want)))
        assert errs[-1][0] <= GRAD_TOL[dt] < errs[-1][1]
    request.node.user_properties += [("grad_rel_err", max(e[0] for e in errs)),
                                     ("grad_control_rel_err", min(e[1] for e in errs))]
    with pytest.raises(RuntimeError, match="no gradient"):
        ma.memory_read_cuda(*leaves)


@pytest.mark.cuda
def test_l2_merge_waits_for_sms_another_stream_holds():
    """The L2 merge's blocks wait for their tile's other splits inside the
    launch, so its grid is launched cooperatively.  A kernel on a second
    stream holds 40 SMs for 4 s (200 KB of shared memory a block: no read
    block fits beside one); a forced L2 read at 512p fp32 (4 splits of 32
    tiles, 128 blocks, more than the 92 SMs left) must wait until its whole grid is
    resident, then give the plain read's result.  Launched without the
    attribute, part of the grid spins at the barrier and traps after
    2^32 cycles, which ends the CUDA context: so the case runs in a child
    process (otvm_tpu_torch/tools/coresidency.py)."""
    _cuda_ready()
    from otvm_tpu_torch.tools import coresidency

    res = coresidency.run_case()
    assert res.get("held_resident") == coresidency.HELD, res
    assert res.get("finished"), res
    assert res["rel_err"] <= READ_TOL[torch.float32], res
    assert not res["hold_running_at_read_end"], res      # it waited for the held SMs


@pytest.mark.cuda
def test_l2_merge_read_replays_from_a_cuda_graph():
    """A cooperative launch captures in a CUDA graph: one forced L2 read,
    its workspace made on the capture stream first, replays to the eager
    read's bits (in a child process, as a failed capture may leave the
    context unusable)."""
    _cuda_ready()
    from otvm_tpu_torch.tools import coresidency

    res = coresidency.run_child(coresidency._THIS_ROOT, "graph")
    assert res.get("captured") and res.get("replay_bit_identical"), res


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,t,count", [
    (1, 8160, 3, 2),      # 1088x1920, count 2: no split
    (1, 1024, 6, 5),      # 512p, count 5: split, merged through L2 on an H100
    (4, 400, 2, None),    # the training shapes: split, merged in a cluster
])
def test_fp32_read_replays_from_a_cuda_graph(b, hw, t, count):
    """The fp32 read at the split and merge the wrapper picks, captured in
    a CUDA graph after an eager read on the capture stream (which makes the
    library, the cluster table and any workspace), replays to the eager
    read's bits, counted once per replay, and stays within READ_TOL[fp32] of
    the plain read."""
    _cuda_ready()
    q, k, v = (torch.from_numpy(a).cuda() for a in _inputs(b, hw, t, seed=21))
    mask = None if count is None else (torch.arange(t, device="cuda")[None] < count).expand(
        b, t).contiguous()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        eager = ma.memory_read_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with ma.record_launches() as reads, torch.cuda.graph(graph, stream=stream):
        out = ma.memory_read_cuda(q, k, v, mask)
    before = ma.launches
    for _ in range(2):
        graph.replay()
        ma.count_launches(reads)
    torch.cuda.synchronize()
    assert ma.launches == before + 2 and len(reads) == 1
    assert torch.equal(out, eager)
    assert rel_err(out, ma.memory_read_plain(q, k, v, mask)) <= READ_TOL[torch.float32]
