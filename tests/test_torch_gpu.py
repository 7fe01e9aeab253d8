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


@pytest.mark.parametrize("comp", [None, "int8"])
def test_dense_round_on_card_matches_cpu(cuda, comp):
    from repro_torch.fl.backends import DenseBackend
    from repro_torch.kernels.adel_agg import adel_agg, adel_agg_q8
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
    for dev in ("cpu", "cuda"):
        launches = (adel_agg.launches, adel_agg_q8.launches)
        backend = DenseBackend(model, compression=comp, device=dev)
        with torch.backends.cudnn.flags(enabled=False):
            out = backend.run_round(tree_map(lambda a: a.to(dev), params),
                                    xb, yb, wb, mask, p, 0.5,
                                    bias_correct=True)
        outs[dev] = [a.cpu() for a in tree_leaves(out)]
        n = len(tree_leaves(params))
        done = (adel_agg.launches - launches[0],
                adel_agg_q8.launches - launches[1])
        expect = (0, 0) if dev == "cpu" else (
            (n, 0) if comp is None else (0, n))
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
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_plain,
                                              adel_agg_q8, adel_agg_q8_plain)
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
        for g, i in zip(tree_leaves(deltas), ids):
            Ll, F = leaf_dims(g.shape[1:], i)
            x, w = g.reshape(U, Ll, F).contiguous(), leaf_coeff_rows(c, i)
            assert _close(adel_agg(x, w), adel_agg_plain(x, w), 1e-5, 1e-5)
    else:
        payload = compress_deltas(deltas, model.layer_ids(params),
                                  make_compression(comp))
        for (q, s), i in zip(payload, ids):
            w = leaf_coeff_rows(c, i)
            assert _close(adel_agg_q8(q, s, w), adel_agg_q8_plain(q, s, w),
                          1e-5, 1e-5)
