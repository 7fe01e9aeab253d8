"""The port's CUDA kernels on the card. Marked ``gpu``: they skip on a host
without a CUDA device and run on the GPU machine with

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs: f32 rtol = atol = 1e-5 (summation order), bf16 1e-2 (one bf16 ulp),
int8 1e-5; so is a dense CNN round's fold of its own deltas on the card.
The whole round on the card (kernels) is held against the same round on
the CPU (plain versions) at rtol 1e-4 / atol 1e-5, with cuDNN off for it:
with TF32 off cuDNN still picks Winograd convolutions, whose f32 rounding
sits ~1e-3 of the update away from ATen-CPU's; ATen's own CUDA convolution
does not.
"""
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _close(a, b, rtol, atol):
    return bool(((a.float() - b.float()).abs()
                 <= atol + rtol * b.float().abs()).all())


@pytest.mark.parametrize("U,L,F", [(10, 1, 10), (10, 1, 2359296),
                                   (16, 24, 4096), (7, 5, 300), (3, 2, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adel_agg_kernel_matches_plain(cuda, U, L, F, dtype):
    from repro_torch.kernels.adel_agg import adel_agg, adel_agg_plain
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn((U, L, F), generator=gen, device=cuda).to(dtype)
    c = torch.rand((U, L), generator=gen, device=cuda)
    before = adel_agg.launches
    out = adel_agg(g, c)
    torch.cuda.synchronize()
    assert adel_agg.launches == before + 1
    assert out.shape == (L, F) and out.dtype == dtype
    assert _close(out, adel_agg_plain(g, c), **TOL[dtype])


@pytest.mark.parametrize("U,L,F", [(10, 1, 10), (10, 1, 2359296),
                                   (16, 24, 4096), (7, 5, 300)])
def test_adel_agg_q8_kernel_matches_plain(cuda, U, L, F):
    from repro_torch.kernels.adel_agg import adel_agg_q8, adel_agg_q8_plain
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = torch.randn((U, L, F), generator=gen, device=cuda)
    g[:, -1] = 0.0                              # a zero-scale layer
    amax = g.abs().amax(-1)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    q = torch.round(g * inv[..., None]).to(torch.int8)
    c = torch.rand((U, L), generator=gen, device=cuda)
    c[0] = 0.0                                  # a zero-coefficient client
    out = adel_agg_q8(q, amax / 127.0, c)
    torch.cuda.synchronize()
    assert out.shape == (L, F) and out.dtype == torch.float32
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    assert _close(out, adel_agg_q8_plain(q, amax / 127.0, c), 1e-5, 1e-5)


def _fold_leaves(cuda, spec, dtype, seed=0):
    """Leaves (U, rows, F) of ``dtype`` and their layer ids from ``spec``, a
    list of (rows, F, stacked), against a (U, L) coefficient matrix."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    U, L = 10, 40
    leaves, ids = [], []
    for k, (rows, F, stacked) in enumerate(spec):
        leaves.append(torch.randn((U, rows, F), generator=gen,
                                  device=cuda).to(dtype))
        if not stacked:
            ids.append(k % L)
        elif k % 2:        # a host-side range: id0 + row
            ids.append(torch.arange(k % 7, k % 7 + rows))
        else:              # ids on the device, in any order
            ids.append(torch.randperm(L, device=cuda)[:rows])
    return leaves, ids, torch.rand((U, L), generator=gen, device=cuda)


# every VGG-11 leaf size at full width (whole-tensor leaves), and a table
# of 70 leaves, split over two launches: stacked and scalar ids, ragged F
VGG11_F = [64, 64, 64, 1728, 128, 128, 128, 73728, 256, 256, 256, 294912,
           256, 256, 256, 589824, 512, 512, 512, 1179648, 512, 512, 512,
           2359296, 512, 512, 512, 2359296, 512, 512, 512, 2359296, 512,
           262144, 512, 262144, 10, 5120]
FOLD_TABLES = {
    "vgg11": [(1, F, False) for F in VGG11_F],
    "two_launches": [(1 + k % 3, [300, 7, 4096, 1000, 8, 2048][k % 6],
                      k % 3 > 0) for k in range(70)],
}


@pytest.mark.parametrize("table", sorted(FOLD_TABLES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adel_agg_grouped_matches_plain(cuda, table, dtype):
    """One grouped launch per MAX_LEAVES leaves, each leaf's weights read
    from the (U, L) matrix through its layer ids."""
    from repro_torch.kernels.adel_agg import (MAX_LEAVES, adel_agg_grouped,
                                              adel_agg_grouped_plain)
    leaves, ids, c = _fold_leaves(cuda, FOLD_TABLES[table], dtype)
    before = adel_agg_grouped.launches
    outs = adel_agg_grouped(leaves, ids, c)
    torch.cuda.synchronize()
    assert adel_agg_grouped.launches - before == -(-len(leaves) // MAX_LEAVES)
    for out, ref, x in zip(outs, adel_agg_grouped_plain(leaves, ids, c),
                           leaves):
        assert out.shape == x.shape[1:] and out.dtype == dtype
        assert _close(out, ref, **TOL[dtype]), (out.float() - ref.float()).abs().max()


def _quantize(g):
    """The wire's int8 absmax quantization of (U, L, F) deltas."""
    amax = g.abs().amax(-1)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    return torch.round(g * inv[..., None]).to(torch.int8), amax / 127.0


@pytest.mark.parametrize("table", sorted(FOLD_TABLES))
def test_adel_agg_q8_grouped_matches_plain(cuda, table):
    """One grouped int8 launch per MAX_LEAVES_Q8 leaves, each leaf's weights
    coeff[u, id] * scales[u, row]; a zero-scale row folds to exactly 0."""
    from repro_torch.kernels.adel_agg import (MAX_LEAVES_Q8, adel_agg_q8,
                                              adel_agg_q8_grouped,
                                              adel_agg_q8_grouped_plain)
    leaves, ids, c = _fold_leaves(cuda, FOLD_TABLES[table], torch.float32,
                                  seed=2)
    leaves[0][:, 0] = 0.0                       # a zero-scale row
    c[3] = 0.0                                  # a zero-coefficient client
    qs, scales = zip(*(_quantize(x) for x in leaves))
    before = (adel_agg_q8_grouped.launches, adel_agg_q8.launches)
    outs = adel_agg_q8_grouped(list(qs), list(scales), ids, c)
    torch.cuda.synchronize()
    assert (adel_agg_q8_grouped.launches - before[0],
            adel_agg_q8.launches - before[1]) == (
                -(-len(leaves) // MAX_LEAVES_Q8), 0)
    refs = adel_agg_q8_grouped_plain(qs, scales, ids, c)
    for out, ref, x in zip(outs, refs, leaves):
        assert out.shape == x.shape[1:] and out.dtype == torch.float32
        assert _close(out, ref, 1e-5, 1e-5), (out - ref).abs().max()
    assert torch.equal(outs[0][0], torch.zeros_like(outs[0][0]))


def test_kernel_wrappers_check_their_inputs(cuda):
    from repro_torch.kernels.adel_agg import adel_agg, adel_agg_q8
    g = torch.zeros((4, 2, 8), device=cuda)
    with pytest.raises(ValueError):
        adel_agg(g, torch.zeros((4, 3), device=cuda))           # shape
    with pytest.raises(ValueError):
        adel_agg(g.transpose(1, 2), torch.zeros((4, 8), device=cuda))
    with pytest.raises(TypeError):
        adel_agg(g.half(), torch.zeros((4, 2), device=cuda))     # dtype
    with pytest.raises(TypeError):
        adel_agg_q8(g, torch.zeros((4, 2), device=cuda),
                    torch.zeros((4, 2), device=cuda))
    from repro_torch.kernels.adel_agg import adel_agg_grouped
    c = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        adel_agg_grouped([g, g.to(torch.bfloat16)], [0, 1], c)   # mixed dtypes
    with pytest.raises(ValueError):
        adel_agg_grouped([g.transpose(1, 2)], [torch.arange(8)], c)
    with pytest.raises(ValueError):
        adel_agg_grouped([g], [torch.tensor([0, 3])], c)         # id >= L
    with pytest.raises(TypeError):
        adel_agg_grouped([g.half()], [torch.arange(2)], c)
    from repro_torch.kernels.adel_agg import adel_agg_q8_grouped
    q, s = g.to(torch.int8), torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError):
        adel_agg_q8_grouped([g], [s], [torch.arange(2)], c)      # not int8
    with pytest.raises(ValueError):
        adel_agg_q8_grouped([q], [s[:, :1]], [torch.arange(2)], c)  # scales
    with pytest.raises(ValueError):
        adel_agg_q8_grouped([q], [s], [torch.tensor([0, 3])], c)    # id >= L
    with pytest.raises(ValueError):
        adel_agg_q8_grouped([q], [s.cpu()], [torch.arange(2)], c)   # device


@pytest.mark.parametrize("comp", [None, "int8"])
def test_dense_round_on_card_matches_cpu(cuda, comp):
    from repro_torch.fl.backends import DenseBackend
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_q8, adel_agg_q8_grouped)
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_leaves, tree_map

    model = make_cnn()
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: p + 0.05 * torch.randn(p.shape, generator=gen),
                      model.init(gen, "cpu"))
    rng = np.random.default_rng(0)
    U, S = 4, 6
    xb = torch.from_numpy(rng.standard_normal((U, S, 28, 28, 1)).astype(
        np.float32))
    yb = torch.from_numpy(rng.integers(0, 10, (U, S)))
    wb = torch.full((U, S), 1.0 / S)
    mask = torch.from_numpy((rng.uniform(size=(U, model.L)) > 0.3).astype(
        np.float32))
    p = torch.full((model.L,), 0.1)
    outs = {}
    # on the card: one grouped launch for the round's f32 leaves
    # uncompressed, one grouped int8 launch for int8
    counters = (adel_agg_grouped, adel_agg_q8_grouped, adel_agg_q8, adel_agg)
    for dev in ("cpu", "cuda"):
        launches = [k.launches for k in counters]
        backend = DenseBackend(model, compression=comp, device=dev)
        with torch.backends.cudnn.flags(enabled=False):
            out = backend.run_round(tree_map(lambda a: a.to(dev), params),
                                    xb, yb, wb, mask, p, 0.5,
                                    bias_correct=True)
        outs[dev] = [a.cpu() for a in tree_leaves(out)]
        n = len(tree_leaves(params))
        done = tuple(k.launches - b for k, b in zip(counters, launches))
        expect = (0, 0, 0, 0) if dev == "cpu" else (
            (1, 0, 0, 0) if comp is None else (0, 1, 0, 0))
        assert done == expect, (dev, done)
    steps = [0.0] * n
    if comp == "int8":
        # a delta on a rounding boundary may land one code apart: allow one
        # quantization step per client, sum_u c[u, l] * scale[u, l]
        from repro_torch.core.aggregation import layer_coefficients
        from repro_torch.core.compression import (compress_deltas,
                                                  make_compression)
        backend = DenseBackend(model, device="cpu")
        payload = compress_deltas(backend._deltas(params, xb, yb, wb, 0.5),
                                  model.layer_ids(params),
                                  make_compression("int8"))
        c = layer_coefficients(mask, p)
        steps = [float((c[:, l] * s[:, 0]).sum()) for l, (_, s) in
                 zip(tree_leaves(model.layer_ids(params)), payload)]
    for a, b, step in zip(outs["cuda"], outs["cpu"], steps):
        assert _close(a, b, 1e-4, 1e-5 + 1.0001 * step), (a - b).abs().max()


@pytest.mark.parametrize("comp", [None, "int8"])
def test_dense_round_fold_matches_plain_on_card(cuda, comp):
    """The fold of a CNN round's own deltas on the card: the kernels
    against their plain versions on the same CUDA tensors."""
    from repro_torch.core.aggregation import layer_coefficients
    from repro_torch.core.compression import compress_deltas, make_compression
    from repro_torch.fl.backends import DenseBackend
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_grouped_plain,
                                              adel_agg_plain, adel_agg_q8,
                                              adel_agg_q8_grouped,
                                              adel_agg_q8_grouped_plain,
                                              adel_agg_q8_plain)
    from repro_torch.kernels.ops import leaf_coeff_rows, leaf_dims
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_leaves

    model = make_cnn()
    gen = torch.Generator().manual_seed(1)
    params = model.init(gen, cuda)
    U, S = 4, 6
    xb = torch.randn((U, S, 28, 28, 1), generator=gen).to(cuda)
    yb = torch.randint(0, 10, (U, S), generator=gen).to(cuda)
    wb = torch.full((U, S), 1.0 / S, device=cuda)
    mask = (torch.rand((U, model.L), generator=gen) > 0.3).float().to(cuda)
    c = layer_coefficients(mask, torch.full((model.L,), 0.1, device=cuda))
    deltas = DenseBackend(model, device=cuda)._deltas(params, xb, yb, wb, 0.5)
    ids = tree_leaves(model.layer_ids(params))
    if comp is None:
        xs = []
        for g, i in zip(tree_leaves(deltas), ids):
            Ll, F = leaf_dims(g.shape[1:], i)
            x, w = g.reshape(U, Ll, F).contiguous(), leaf_coeff_rows(c, i)
            assert _close(adel_agg(x, w), adel_agg_plain(x, w), 1e-5, 1e-5)
            xs.append(x)
        for out, ref in zip(adel_agg_grouped(xs, ids, c),
                            adel_agg_grouped_plain(xs, ids, c)):
            assert _close(out, ref, 1e-5, 1e-5)
    else:
        payload = compress_deltas(deltas, model.layer_ids(params),
                                  make_compression(comp))
        for (q, s), i in zip(payload, ids):
            w = leaf_coeff_rows(c, i)
            assert _close(adel_agg_q8(q, s, w), adel_agg_q8_plain(q, s, w),
                          1e-5, 1e-5)
        qs, scales = [q for q, _ in payload], [s for _, s in payload]
        for out, ref in zip(adel_agg_q8_grouped(qs, scales, ids, c),
                            adel_agg_q8_grouped_plain(qs, scales, ids, c)):
            assert _close(out, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_one_client_fold_matches_plain_on_card(cuda, dtype):
    """The temporal backend's fold: U = 1 tables (one client's leaves and
    its (1, L) coefficient row), stacked and scalar layer ids, ragged F."""
    from repro_torch.kernels.adel_agg import (adel_agg_grouped,
                                              adel_agg_grouped_plain,
                                              adel_agg_q8_grouped,
                                              adel_agg_q8_grouped_plain)
    gen = torch.Generator(device=cuda).manual_seed(3)
    L = 6
    shapes = [(1, 1, 7), (1, 3, 300), (1, 1, 4096), (1, 2, 1)]
    ids = [2, torch.tensor([0, 1, 5]), 4, torch.tensor([3, 3])]
    coeff = torch.rand((1, L), generator=gen, device=cuda)
    leaves = [torch.randn(sh, generator=gen, device=cuda) for sh in shapes]
    if dtype == torch.int8:
        qs = [torch.randint(-127, 128, sh, generator=gen, device=cuda,
                            dtype=torch.int8) for sh in shapes]
        ss = [torch.rand(sh[:2], generator=gen, device=cuda) for sh in shapes]
        pairs = zip(adel_agg_q8_grouped(qs, ss, ids, coeff),
                    adel_agg_q8_grouped_plain(qs, ss, ids, coeff))
        tol = TOL[torch.float32]
    else:
        leaves = [x.to(dtype) for x in leaves]
        pairs = zip(adel_agg_grouped(leaves, ids, coeff),
                    adel_agg_grouped_plain(leaves, ids, coeff))
        tol = TOL[dtype]
    for out, ref in pairs:
        assert _close(out, ref, **tol), (out.float() - ref.float()).abs().max()


@pytest.mark.parametrize("comp", [None, "int8"])
@pytest.mark.parametrize("backend,knobs,launches", [
    ("chunked", {"chunk_size": 2}, 2), ("temporal", {}, 4),
    ("hierarchical", {"regions": 2}, 2)])
def test_backend_round_on_card_matches_cpu(cuda, backend, knobs, launches,
                                           comp):
    """A CNN round of each backend on the card: one grouped fold launch a
    chunk, client or region (f32 uncompressed, int8 compressed), and the
    same round on the CPU (plain versions) to the dense round's
    tolerance, cuDNN off."""
    from repro_torch.fl.backends import make_backend
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_q8, adel_agg_q8_grouped)
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_leaves, tree_map

    model = make_cnn()
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: p + 0.05 * torch.randn(p.shape, generator=gen),
                      model.init(gen, "cpu"))
    rng = np.random.default_rng(0)
    U, S = 4, 6
    xb = torch.from_numpy(rng.standard_normal((U, S, 28, 28, 1)).astype(
        np.float32))
    yb = torch.from_numpy(rng.integers(0, 10, (U, S)))
    wb = torch.full((U, S), 1.0 / S)
    mask = torch.from_numpy((rng.uniform(size=(U, model.L)) > 0.3).astype(
        np.float32))
    mask[0] = 1.0
    p = torch.full((model.L,), 0.1)
    counters = (adel_agg_grouped, adel_agg_q8_grouped, adel_agg_q8, adel_agg)
    outs = {}
    for dev in ("cpu", "cuda"):
        before = [k.launches for k in counters]
        bk = make_backend(backend, model, compression=comp, device=dev,
                          **knobs)
        with torch.backends.cudnn.flags(enabled=False):
            out = bk.run_round(tree_map(lambda a: a.to(dev), params),
                               xb, yb, wb, mask, p, 0.5, bias_correct=True)
        outs[dev] = [a.cpu() for a in tree_leaves(out)]
        done = tuple(k.launches - b for k, b in zip(counters, before))
        expect = (0, 0, 0, 0) if dev == "cpu" else (
            (launches, 0, 0, 0) if comp is None else (0, launches, 0, 0))
        assert done == expect, (dev, done)
    steps = [0.0] * len(outs["cpu"])
    if comp == "int8":
        # a delta on a rounding boundary may land one code apart: allow one
        # quantization step per client, sum_u c[u, l] * scale[u, l]
        from repro_torch.core.aggregation import layer_coefficients
        from repro_torch.core.compression import (compress_deltas,
                                                  make_compression)
        payload = compress_deltas(bk._deltas(tree_map(lambda a: a.cuda(),
                                                      params),
                                             xb.cuda(), yb.cuda(), wb.cuda(),
                                             0.5),
                                  model.layer_ids(params),
                                  make_compression("int8"))
        c = layer_coefficients(mask, p)
        steps = [float((c[:, l] * s.cpu()[:, 0]).sum()) for l, (_, s) in
                 zip(tree_leaves(model.layer_ids(params)), payload)]
    for a, b, step in zip(outs["cuda"], outs["cpu"], steps):
        assert _close(a, b, 1e-4, 1e-5 + 1.0001 * step), (a - b).abs().max()


def _cnn_round_inputs():
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_map
    model = make_cnn()
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: p + 0.05 * torch.randn(p.shape, generator=gen),
                      model.init(gen, "cpu"))
    rng = np.random.default_rng(0)
    U, S = 4, 6
    xb = torch.from_numpy(rng.standard_normal((U, S, 28, 28, 1)).astype(
        np.float32))
    yb = torch.from_numpy(rng.integers(0, 10, (U, S)))
    wb = torch.full((U, S), 1.0 / S)
    mask = torch.from_numpy((rng.uniform(size=(U, model.L)) > 0.3).astype(
        np.float32))
    mask[0] = 1.0
    return model, params, (xb, yb, wb, mask, torch.full((model.L,), 0.1))


@pytest.mark.parametrize("comp", [None, "int8"])
def test_one_nccl_rank_matches_dense_on_card(cuda, tmp_path, comp):
    """shard_map over a one-rank NCCL group on the card: one grouped fold
    launch and one all_reduce a round, and the round within 1e-4 of the
    dense round's max |update| from the same params and batches (cuDNN
    deterministic: the one all_reduce of one rank is a copy, so the two
    are expected equal)."""
    import torch.distributed as dist

    from repro_torch.fl.backends import ShardMapBackend, make_backend
    from repro_torch.kernels.adel_agg import (adel_agg_grouped,
                                              adel_agg_q8_grouped)
    from repro_torch.tree import tree_leaves, tree_map
    model, params, arrays = _cnn_round_inputs()
    params = tree_map(lambda a: a.to(cuda), params)
    arrays = [a.to(cuda) for a in arrays]
    kernel = adel_agg_grouped if comp is None else adel_agg_q8_grouped
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        outs = {}
        with torch.backends.cudnn.flags(enabled=True, deterministic=True):
            for name in ("dense", "shard_map"):
                bk = make_backend(name, model, compression=comp, device=cuda)
                before = kernel.launches
                outs[name] = bk.run_round(params, *arrays, 0.5,
                                          bias_correct=True)
                torch.cuda.synchronize()
                assert kernel.launches == before + 1
        assert isinstance(bk, ShardMapBackend)
        assert bk.describe()["shards"] == 1
    finally:
        dist.destroy_process_group()
    upd = max(float((d - w).abs().max()) for d, w in
              zip(tree_leaves(outs["dense"]), tree_leaves(params)))
    diff = max(float((a - d).abs().max()) for a, d in
               zip(tree_leaves(outs["shard_map"]), tree_leaves(outs["dense"])))
    assert upd > 0 and diff <= 1e-4 * upd, (diff, upd)


@pytest.mark.parametrize("backend", ["dense", "shard_map", "chunked"])
def test_prefetch_matches_serial_on_card(cuda, backend):
    """The prefetch driver on the card (its gathers on a side stream)
    against serial: History equal and params bit-equal under
    cudnn.deterministic."""
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.scheduler import solve
    from repro_torch.core.types import AnalysisConfig
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.partition import dirichlet_partition, stack_clients
    from repro_torch.fl.server import run_federated
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_leaves
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=400, n_test=200, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, 6, alpha=0.5, seed=0)
    data = (*stack_clients(x_tr, y_tr, parts), x_te, y_te)
    model = make_cnn()
    cfg = AnalysisConfig.default(U=6, L=model.L, R=4,
                                 T_max=4 * model.L * 0.5, eta0=0.5, seed=0)
    schedule = solve(cfg, "adam", steps=100, device="cpu")
    knobs = {"chunk_size": 4} if backend == "chunked" else {}
    out = {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        for pipe in ("serial", "prefetch"):
            policy = make_policy("adel", cfg, schedule=schedule, device=cuda)
            out[pipe] = run_federated(
                model, policy, cfg, *data, seed=0, device=cuda,
                exec=ExecSpec(backend=backend, pipeline=pipe, **knobs))
    (ps, hs), (pp, hp) = out["serial"], out["prefetch"]
    assert hs.as_dict() == hp.as_dict()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ps),
                                                 tree_leaves(pp)))


def _buffered_plans(model, n_rounds, U=4, S=6):
    """Per round: CNN inputs, a mask with stragglers and its round context
    on a clock of 1.2 a round (the later rounds see earlier arrivals)."""
    from repro_torch.core.baselines import RoundPlan
    from repro_torch.core.types import AnalysisConfig
    from repro_torch.fl.runtime import _round_context
    rng = np.random.default_rng(5)
    cfg = AnalysisConfig.default(U=U, L=model.L, R=5, T_max=6.0, seed=0)
    out = []
    for t in range(n_rounds):
        xb = torch.from_numpy(rng.standard_normal((U, S, 28, 28, 1)).astype(
            np.float32))
        yb = torch.from_numpy(rng.integers(0, 10, (U, S)))
        wb = torch.full((U, S), 1.0 / S)
        z = rng.integers(0, model.L + 1, U)
        z[0] = model.L
        mask = torch.from_numpy((z[:, None] >= (model.L - np.arange(
            model.L))[None, :]).astype(np.float32))
        p = torch.full((model.L,), 0.1)
        plan = RoundPlan(mask=mask, p=p, batch_sizes=torch.full((U,), 4.0),
                         elapsed=1.2, bias_correct=True)
        out.append(((xb, yb, wb, mask, p),
                    _round_context(t, 1.2 * t, plan, cfg, U)))
    return out


@pytest.mark.parametrize("comp", [None, "int8"])
def test_buffered_round_launches_on_card(cuda, comp):
    """Buffered CNN rounds on the card: one grouped fold launch for the
    on-time fold plus one a carry slot folded that round (``last_carry``'s
    staleness histogram has one entry a slot), no per-leaf launch; each
    round within the dense round's tolerance of the same round on the CPU
    (plain versions), both fed the CPU's params, cuDNN off."""
    from repro_torch.fl.backends import make_backend
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_q8, adel_agg_q8_grouped)
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    model = make_cnn()
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: p + 0.05 * torch.randn(p.shape, generator=gen),
                      model.init(gen, "cpu"))
    bks = {dev: make_backend("buffered", model, lam=0.5, compression=comp,
                             device=dev) for dev in ("cpu", "cuda")}
    kernel = adel_agg_grouped if comp is None else adel_agg_q8_grouped
    folded = 0
    for arrays, ctx in _buffered_plans(model, 4):
        outs = {}
        for dev, bk in bks.items():
            before = [k.launches for k in (kernel, adel_agg, adel_agg_q8)]
            with torch.backends.cudnn.flags(enabled=False):
                out = bk.run_round(tree_map(lambda a: a.to(dev), params),
                                   *arrays, 0.5, bias_correct=True, ctx=ctx)
            torch.cuda.synchronize()
            done = [k.launches - b for k, b in
                    zip((kernel, adel_agg, adel_agg_q8), before)]
            expect = ([0, 0, 0] if dev == "cpu" else
                      [1 + len(bk.last_carry["stale"]), 0, 0])
            assert done == expect, (dev, done, bk.last_carry)
            outs[dev] = [a.cpu() for a in tree_leaves(out)]
        assert bks["cpu"].last_carry == bks["cuda"].last_carry
        folded += len(bks["cuda"].last_carry["stale"])
        # int8: a code on a rounding boundary may land one step apart
        tol = 1e-5 if comp is None else 1e-3
        for a, b in zip(outs["cuda"], outs["cpu"]):
            assert _close(a, b, 1e-4, tol), (a - b).abs().max()
        params = tree_unflatten(params, outs["cpu"])
    assert folded > 0


@pytest.mark.parametrize("comp", [None, "int8"])
def test_buffered_slot_owns_its_payload_on_card(cuda, comp):
    """A slot banked at round 0 and folded at round 2 on the card holds
    exactly what it held at banking time (nothing the rounds in between
    allocated or wrote reached it), and its fold equals the plain fold of
    that copy within the kernel tolerance."""
    from repro_torch.core.aggregation import aggregate_with_coeffs
    from repro_torch.core.compression import aggregate_compressed
    from repro_torch.fl.backends import apply_update, make_backend
    from repro_torch.kernels.adel_agg import (adel_agg_grouped_plain,
                                              adel_agg_q8_grouped_plain)
    from repro_torch.models.paper_models import make_cnn
    from repro_torch.tree import tree_leaves, tree_map
    model = make_cnn()
    params = model.init(torch.Generator().manual_seed(0), cuda)
    bk = make_backend("buffered", model, lam=0.5, compression=comp,
                      device=cuda)
    seen, fold_slot = [], bk._fold_slot

    def spy(p, slot, w):
        out = fold_slot(p, slot, w)
        seen.append((p, slot, w, out))
        return out

    bk._fold_slot = spy
    copy0 = None
    for t, (arrays, ctx) in enumerate(_buffered_plans(model, 3)):
        if t == 1:
            ctx.sim_end = ctx.sim_start + 1e-6       # nothing lands yet
        if t == 2:
            ctx.sim_start, ctx.sim_end = 50.0, 51.2  # everything has landed
        params = bk.run_round(params, *arrays, 0.5, bias_correct=True,
                              ctx=ctx)
        if t == 0:
            copy0 = tree_map(lambda a: a.clone(), bk._slots[0]["banked"])
    torch.cuda.synchronize()
    p_in, slot, w, out = next(s for s in seen if s[1]["round"] == 0)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(slot["banked"]), tree_leaves(copy0)))
    coeffs = (slot["c_late"] * torch.from_numpy(w)[:, None])
    cpu = lambda tree: tree_map(lambda a: a.cpu() if torch.is_tensor(a)
                                else a, tree)
    ids = model.layer_ids(p_in)
    if comp is None:
        agg = aggregate_with_coeffs(cpu(copy0), cpu(ids), coeffs)
    else:
        agg = aggregate_compressed(cpu(copy0), cpu(p_in), cpu(ids), None,
                                   None, cfg=bk.compression, coeffs=coeffs)
    expect = apply_update(cpu(p_in), agg)
    for a, b in zip(tree_leaves(out), tree_leaves(expect)):
        assert _close(a.cpu(), b, 1e-5, 1e-6), (a.cpu() - b).abs().max()


def test_hierarchical_fleet_round_launches_per_region(cuda):
    """run_fleet on the card over a million-device parametric population
    with four edge regions: one grouped fold launch a non-empty region a
    round (the ledger's region census from the cohort's device ids), and
    no other fold launch."""
    from repro_torch import obs
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.fleet.engine import partition_fleet, run_fleet
    from repro_torch.fleet.population import make_population
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_q8_grouped)
    from repro_torch.models.paper_models import make_cnn
    x, y, xt, yt = make_image_dataset("mnist", n_train=600, n_test=100)
    data = partition_fleet(x, y, xt, yt, 64, alpha=0.5)
    pop = make_population("parametric:longtail-mobile", size=1_000_000,
                          availability="bernoulli",
                          availability_kwargs=(("rate", 0.7),), regions=4)
    counters = (adel_agg_grouped, adel_agg_q8_grouped, adel_agg)
    before = [k.launches for k in counters]
    sink = obs.MemorySink()
    _, hist = run_fleet(make_cnn(), pop, data=data, rounds=3, cohort_size=16,
                        solver_steps=100, device=cuda, tracer=obs.Tracer(sink),
                        exec=ExecSpec(backend="hierarchical", regions=4))
    rows = obs.ledger_rows(sink.records)
    assert len(rows) == 3 and all(r["regions"] == 4 for r in rows)
    done = [k.launches - b for k, b in zip(counters, before)]
    assert done == [sum(r["regions"] for r in rows), 0, 0], done
    assert all(np.isfinite(v) for v in hist.train_loss)


# ---------------------------------------------------------------------------
# the LM kernels: flash attention and the SSD chunk scan
# ---------------------------------------------------------------------------
# flash: f32 rtol = atol = 2e-5 (f32 sums in another order, as the CPU
# parity tests against the Pallas kernel); bf16 rtol 1e-2, atol 1e-3 (both
# round one f32 result to bf16, one ulp apart at most, < 0.8% of the value).
# SSD: rtol = atol = 1e-4 (f32 chunk sums, exp of the cumulative log-decay,
# in another order).
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window,layout", [
    (2, 25, 5, 1024, 1024, 64, True, 256, "bhsd"),    # hymba heads, shorter S
    (2, 25, 5, 1024, 1024, 64, True, 256, "bshd"),    # ... as the model lays them out
    (1, 32, 4, 512, 512, 128, True, 0, "bhsd"),       # yi-6b heads
    (1, 56, 8, 512, 512, 128, True, 0, "bshd"),       # arctic-480b, G = 7
    (1, 4, 2, 1000, 1000, 64, True, 100, "bhsd"),     # ragged S
    (1, 4, 2, 1000, 1000, 128, True, 0, "bshd"),      # hd 128, Sk % 128 != 0
    (2, 2, 2, 128, 300, 64, False, 0, "bhsd"),        # non-causal, Sq != Sk
    (1, 8, 1, 77, 77, 128, True, 0, "bhsd"),          # MQA, S < one tile
    (1, 2, 1, 200, 40, 64, True, 16, "bhsd"),         # rows that see no key
    (1, 4, 2, 700, 900, 128, False, 200, "bshd"),     # a window, not causal
    (1, 16, 16, 512, 512, 64, False, 0, "bshd"),      # seamless encoder
    (1, 4, 4, 512, 256, 64, False, 0, "bhsd"),        # seamless cross, Sq > Sk
    (1, 14, 2, 1000, 1000, 128, True, 0, "bshd"),     # llava, G = 7, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, H, KV, Sq, Sk, hd,
                                              causal, window, layout, dtype):
    """``layout`` "bshd" hands the kernel (B, H, S, hd) views of (B, S, H, hd)
    tensors, read through their strides; the output takes q's layout."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=cuda).manual_seed(0)

    def make(heads, S):
        shape = (B, heads, S, hd) if layout == "bhsd" else (B, S, heads, hd)
        t = torch.randn(shape, generator=gen, device=cuda).to(dtype)
        return t if layout == "bhsd" else t.transpose(1, 2)

    q, k, v = make(H, Sq), make(KV, Sk), make(KV, Sk)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert out.stride() == q.stride()
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert _close(out, ref, **FLASH_TOL[dtype]), (out.float() - ref.float()).abs().max()


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "flash_fwd_kernel_tc"),
                                          (torch.float32, "flash_fwd_kernel_tf32")])
def test_flash_dtype_picks_the_kernel(cuda, dtype, kernel):
    """bf16 runs only the bf16 kernel, f32 only the 3xTF32 one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((1, 4, 256, 64), device=cuda).to(dtype)
    k = torch.randn((1, 2, 256, 64), device=cuda).to(dtype)
    flash_attention(q, k, k)
    torch.cuda.synchronize()
    # the profiler drops a window's first kernels and, when it stops right
    # after them, its last: spin kernels open the window, the card idles
    # before it closes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            torch.cuda._sleep(1_000)
        torch.cuda._sleep(20_000_000)
        flash_attention(q, k, k)
        torch.cuda.synchronize()
        time.sleep(0.5)
    names = [e.key for e in prof.key_averages() if "flash_fwd_kernel" in e.key]
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48),
                                           (False, 48)])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (1, 1000), (63, 65), (65, 63),
                                   (65, 65), (63, 1000), (1000, 1),
                                   (1000, 1000)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_f32_kernel_at_its_tile_edges(cuda, hd, Sq, Sk, causal, window):
    """The 3xTF32 kernel where its 128-row q tiles, its 64- (hd 64) and
    32-key (hd 128) K/V tiles and its 8-key k-steps end: (B, H, S, hd) views
    of the model's (B, S, H, hd) tensors, GQA, within FLASH_TOL of the plain
    version; a row with no visible key exactly 0; two calls bit for bit."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     visible_mask)
    gen = torch.Generator(device=cuda).manual_seed(Sq * 7 + Sk + hd)
    B, H, KV = 2, 4, 2
    q, k, v = (torch.randn((B, S, heads, hd), generator=gen,
                           device=cuda).transpose(1, 2)
               for S, heads in ((Sq, H), (Sk, KV), (Sk, KV)))
    out = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    assert torch.equal(out, again)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert _close(out, ref, **FLASH_TOL[torch.float32]), (out - ref).abs().max()
    empty = ~visible_mask(Sq, Sk, causal, window, cuda).any(-1)
    assert (out[:, :, empty] == 0).all()


def test_flash_tiles_are_the_librarys(cuda):
    """The wrapper's q and key tiles (its grid check, the CPU emulation of
    the f32 kernel) are the built library's."""
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import (KEY_TILE, Q_TILE,
                                                     library_tiles)
    assert library_tiles(load_library("flash_attention")) == (Q_TILE, KEY_TILE)


@pytest.mark.parametrize("G,r,S,P,N,chunk", [
    (2, 64, 1024, 50, 16, 64),     # hymba-1.5b: B=2, 64 heads, P=50, N=16
    (1, 32, 512, 64, 128, 64),     # mamba2-370m: P=64, N=128
    (2, 3, 256, 16, 8, 128),       # a long chunk
    (6, 1, 64, 7, 5, 16),          # per-head b, c (G = BH), odd widths
])
def test_ssd_scan_kernel_matches_plain(cuda, G, r, S, P, N, chunk):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=cuda).manual_seed(0)
    BH = G * r
    xdt = torch.randn((BH, S, P), generator=gen, device=cuda)
    la = -torch.rand((BH, S), generator=gen, device=cuda)
    b = 0.3 * torch.randn((G, S, N), generator=gen, device=cuda)
    c = 0.3 * torch.randn((G, S, N), generator=gen, device=cuda)
    before = ssd_scan.launches
    y = ssd_scan(xdt, la, b, c, chunk=chunk)
    again = ssd_scan(xdt, la, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert torch.equal(y, again)            # fixed order of sums, no atomics
    ref = ssd_scan_plain(xdt, la, b, c, chunk=chunk)
    assert _close(y, ref, **SSD_TOL), (y - ref).abs().max()


@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (2, 64, 4096, 50, 16, 64),     # hymba-1.5b's prefill, as the model lays it out
    (1, 5, 256, 7, 5, 32),         # odd widths
    (8, 64, 256, 50, 16, 64),      # hymba-1.5b's training block (8 rows of 256)
])
def test_ssd_scan_kernel_reads_the_model_layout(cuda, B, H, S, P, N, chunk):
    """(B, H, S, P) and (B, H, S) views of the model's (B, S, H, P) and
    (B, S, H) tensors, read through their strides: y comes back in xdt's
    layout, equal to the contiguous call's and within SSD_TOL of the plain
    version."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=cuda).manual_seed(3)
    xdt = torch.randn((B, S, H, P), generator=gen, device=cuda).transpose(1, 2)
    la = -0.5 * torch.rand((B, S, H), generator=gen,
                           device=cuda).transpose(1, 2)
    b = 0.3 * torch.randn((B, S, N), generator=gen, device=cuda)
    c = 0.3 * torch.randn((B, S, N), generator=gen, device=cuda)
    before = ssd_scan.launches
    y = ssd_scan(xdt, la, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.shape == xdt.shape and y.stride() == xdt.stride()
    assert torch.equal(y, ssd_scan(xdt, la, b, c, chunk=chunk))
    flat = ssd_scan(xdt.reshape(B * H, S, P).contiguous(),
                    la.reshape(B * H, S).contiguous(), b, c, chunk=chunk)
    assert torch.equal(y.reshape(B * H, S, P), flat)
    ref = ssd_scan_plain(xdt, la, b, c, chunk=chunk)
    assert _close(y, ref, **SSD_TOL), (y - ref).abs().max()


def test_ssd_tile_and_plan_are_the_librarys(cuda):
    """The wrapper's TILE (the CPU emulation's tile) is the built library's,
    and the plan a call takes fits a block: hymba-1.5b's prefill in one
    slice of 64 columns with a producer warpgroup, its training block in
    slices of 56 with one warpgroup, mamba2-370m's in two of 32, N 256
    refused."""
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.ssd_scan import TILE, kernel_plan
    assert load_library("ssd_scan").ssd_scan_tile() == TILE
    hymba = kernel_plan(2, 64, 4096, 50, 16)
    assert (hymba["pw"], hymba["slices"], hymba["groups"]) == (64, 1, 2)
    assert hymba["bytes"] <= 232448 and 2 <= hymba["stages"] <= 3
    train = kernel_plan(8, 64, 256, 50, 16)
    assert (train["pw"], train["slices"], train["groups"]) == (56, 1, 1)
    mamba2 = kernel_plan(2, 32, 4096, 64, 128)
    assert (mamba2["pw"], mamba2["slices"], mamba2["groups"]) == (32, 2, 1)
    with pytest.raises(ValueError, match="no SSD plan"):
        kernel_plan(1, 1, 256, 256, 256)


def test_lm_kernel_wrappers_check_their_inputs(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous())
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    # the model's (B, S, H, hd) layout is read through its strides, with
    # no copy; an hd that is not unit-stride is refused, as is a
    # misaligned base
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, 300, 4, 64), device=cuda).to(dtype)
        view = x.transpose(1, 2)
        assert torch.equal(flash_attention(view, view, view),
                           flash_attention(view.contiguous(),
                                           view.contiguous(),
                                           view.contiguous()))
        cols = torch.randn((2, 4, 64, 300), device=cuda).to(dtype)
        with pytest.raises(ValueError, match="unit stride"):
            flash_attention(cols.transpose(2, 3), cols.transpose(2, 3),
                            cols.transpose(2, 3))
        flat = torch.zeros(2 * 4 * 300 * 64 + 1, device=cuda, dtype=dtype)
        odd = flat[1:].view(2, 4, 300, 64)
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(odd, odd, odd)
    x = torch.zeros((2, 100, 8), device=cuda)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, x[..., 0].contiguous(), x, x, chunk=64)
    big = torch.zeros((1, 256, 256), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(big, big[..., 0].contiguous(), big, big, chunk=256)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m", "yi-6b",
                                  "arctic-480b", "deepseek-v2-lite-16b"])
def test_prefill_on_card_matches_cpu(cuda, arch):
    """A reduced model's prefill on the card (the kernels, one launch of
    each per block; MLA is plain) against the same prefill on the CPU
    (their plain versions), f32 with TF32 off: rtol = atol = 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 200),
                           generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(cfg)
    ref = step(params, tokens)
    before = (flash_attention.launches, ssd_scan.launches)
    out = step(tree_map(lambda t: t.to(cuda), params), tokens.to(cuda))
    torch.cuda.synchronize()
    launched = (flash_attention.launches - before[0],
                ssd_scan.launches - before[1])
    assert launched == (cfg.L if cfg.attention == "gqa" else 0,
                        cfg.L if cfg.has_ssm else 0)
    assert _close(out.cpu(), ref, 1e-4, 1e-4), (out.cpu() - ref).abs().max()


@pytest.mark.parametrize("backend", ["dense", "temporal"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m", "qwen1.5-4b",
                                  "arctic-480b", "deepseek-v2-lite-16b"])
def test_lm_round_on_card_matches_cpu(cuda, arch, backend):
    """One LM training round of a reduced model on the card (the kernels
    forward, the plain backwards, the grouped fold) against the same round
    on the CPU (plain versions), f32 with TF32 off: params rtol 1e-4 / atol
    1e-5. Launches: one flash and one SSD scan a block a vmapped call (the
    clients folded into the batch; MLA is plain), one grouped fold a round
    on dense and one a client on temporal. The MoE archs route each
    client's tokens through ``moe_ffn`` (plain PyTorch, as the
    reference)."""
    from repro_torch.configs import get_config
    from repro_torch.fl.backends import make_backend
    from repro_torch.fl.tasks import make_lm_model
    from repro_torch.kernels.adel_agg import adel_agg_grouped
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(arch).reduced()
    model = make_lm_model(cfg)
    U, b, seq = 3, 2, 40
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    xb = torch.randint(0, cfg.vocab, (U, b, seq + 1), generator=gen)
    yb = torch.zeros((U, b), dtype=torch.int32)
    wb = torch.full((U, b), 1.0 / b)
    mask = torch.ones((U, cfg.n_blocks_total))
    mask[1, 0] = 0.0
    p = torch.full((cfg.n_blocks_total,), 0.1)
    args = (xb, yb, wb, mask, p, 0.5)

    def round_on(dev):
        moved = [a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args]
        return make_backend(backend, model, device=dev).run_round(
            tree_map(lambda t: t.to(dev), params), *moved, bias_correct=True)

    ref = round_on("cpu")
    before = (flash_attention.launches, ssd_scan.launches,
              adel_agg_grouped.launches)
    out = round_on(cuda)
    torch.cuda.synchronize()
    calls = 1 if backend == "dense" else U
    assert (flash_attention.launches - before[0],
            ssd_scan.launches - before[1],
            adel_agg_grouped.launches - before[2]) == (
        cfg.L * calls if cfg.attention == "gqa" else 0,
        cfg.L * calls if cfg.has_ssm else 0, calls)
    for a, r in zip(tree_leaves(out), tree_leaves(ref)):
        assert _close(a.cpu(), r, 1e-4, 1e-5), (a.cpu() - r).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_kernel_functions_grads_on_card(cuda, dtype):
    """``FlashAttention`` and ``SSDScan`` under ``vmap(grad)`` over 3
    clients on the card (one launch a call) against autograd through the
    plain versions on the same inputs: f32 rtol = atol = 1e-4 of max(1,
    max|grad|), bf16 flash 2e-2."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ops import gqa_flash
    from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q = torch.randn((3, 2, 130, 6, 64), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((3, 2, 130, 2, 64), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))

    def attn(fn):
        return lambda q, k, v: (fn(q, k, v).float() ** 2).sum()

    kern = attn(lambda q, k, v: gqa_flash(q, k, v, causal=True, window=50))
    plain = attn(lambda q, k, v: flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=50).transpose(1, 2))
    cases = [(kern, plain, (q, k, v), flash_attention)]
    if dtype == torch.float32:
        x = torch.randn((3, 2, 128, 4, 16), generator=gen, device=cuda)
        la = -0.3 * torch.rand((3, 2, 128, 4), generator=gen, device=cuda)
        bc = torch.randn((3, 2, 128, 8), generator=gen, device=cuda)

        def scan(fn):
            return lambda x, la, b: (fn(x.transpose(1, 2), la.transpose(1, 2),
                                        b.contiguous(), b.contiguous())
                                     ** 2).sum()

        cases.append((scan(lambda *a: SSDScan.apply(*a, 64)),
                      scan(lambda *a: ssd_scan_plain(*a, chunk=64)),
                      (x, la, bc), ssd_scan))
    for fn, ref_fn, inputs, counter in cases:
        argnums = tuple(range(len(inputs)))
        before = counter.launches
        got = torch.func.vmap(torch.func.grad(fn, argnums=argnums))(*inputs)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        ref = torch.func.vmap(torch.func.grad(ref_fn, argnums=argnums))(
            *inputs)
        for a, r in zip(got, ref):
            scale = max(1.0, float(r.float().abs().max()))
            assert _close(a, r, tol, tol * scale), \
                float((a.float() - r.float()).abs().max())


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "llava-next-34b"])
def test_frontend_prefill_on_card_matches_cpu(cuda, arch):
    """A reduced vlm or audio model's prefill with its frontend on the card
    (the flash kernel: the encoder's bidirectional self-attention, the
    decoder's causal self- and cross-attention, or the patches prepended)
    against the same prefill on the CPU, f32 with TF32 off: rtol = atol =
    1e-4; one flash launch an attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 200), generator=gen)
    front = 0.02 * torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                               generator=gen)
    step = make_prefill_step(cfg)
    ref = step(params, tokens, front)
    before = flash_attention.launches
    out = step(tree_map(lambda t: t.to(cuda), params), tokens.to(cuda),
               front.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.enc_layers + cfg.L * (
        2 if cfg.enc_layers else 1)
    assert _close(out.cpu(), ref, 1e-4, 1e-4), (out.cpu() - ref).abs().max()


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "hymba-1.5b"])
def test_remat_under_vmap_grad_on_card(cuda, arch):
    """``remat=True`` under ``vmap(grad)`` over 3 clients on the card (the
    recomputed blocks' flash and SSD kernels launched once more in the
    backward, each call on the clients folded into B) against
    ``remat=False`` on the same inputs: loss grads within 1e-5 of max(1,
    max|grad|) (the same kernels and products; the card's reductions may
    pick another order between the two runs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch).reduced()
    params = tr.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (3, 2, 24), generator=gen, device=cuda)
    fr = None
    if cfg.frontend != "none":
        fr = 0.02 * torch.randn((3, 2, cfg.n_frontend_tokens, cfg.d_model),
                                generator=gen, device=cuda)
    per_forward = cfg.enc_layers + cfg.L * (2 if cfg.enc_layers else 1)
    grads, launched = [], []
    for remat in (False, True):
        before = flash_attention.launches
        grads.append(tree_leaves(torch.func.vmap(torch.func.grad(
            lambda p, t, f: tr.loss_fn(p, cfg, t, t, frontend=f,
                                       remat=remat)),
            in_dims=(None, 0, None if fr is None else 0))(params, tok, fr)))
        torch.cuda.synchronize()
        launched.append(flash_attention.launches - before)
    assert launched == [per_forward, 2 * per_forward]
    for a, b in zip(*grads):
        scale = max(1.0, float(b.abs().max()))
        assert _close(a, b, 1e-5, 1e-5 * scale), float((a - b).abs().max())
