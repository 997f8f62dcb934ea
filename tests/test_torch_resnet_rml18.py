"""The residual classifier of O'Shea, Roy and Clancy (2018) in the port, on
the CPU at a small size (128-sample frames, so the flattened map is 2 x 32;
batches of 8), seeded weights, against the plain reference
``tests/resnet_rml18_reference.py``:

- the module in float32 (tight) and in bf16 (within the bf16 rounding of
  its maps);
- the kernel's plain version (``ops/residual_chain_bf16.py``) and the
  kernel's weight layout;
- the checkpoint, ``restore_model`` and ``_make_predictor`` (route
  ``module`` on the CPU; the route by device, dtype and widths);
- ``classify_stream_blocked`` at ``stream.frame_len=1024``;
- the benchmark's reference copy against this one;
- the sites that build or quantize a VT-CNN2 from ``cfg.model`` refusing
  ``model.arch=resnet_rml18``.

The CUDA kernel against its plain version runs only on a card (as in
``chip_smoke.py``'s phase resnet_chain); here it skips.
"""
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modulationdetectioncnn_torch.config import AmcConfig, ModelConfig, apply_overrides
from modulationdetectioncnn_torch.dsp import pipeline as tpipe
from modulationdetectioncnn_torch.dsp.channelizer import design_prototype
from modulationdetectioncnn_torch.models.resnet_rml18 import ResNetRML18, macs_per_frame
from modulationdetectioncnn_torch.ops import residual_chain_bf16 as rc
from modulationdetectioncnn_torch.utils import checkpoint as tckpt
from modulationdetectioncnn_torch.utils import profiler
import resnet_rml18_reference as ref

T_SMALL, BATCH = 128, 8
RESNET = ["model.arch=resnet_rml18", "model.num_classes=24"]


def _model(seed: int, frame_len: int = T_SMALL, dtype: str = "float32") -> ResNetRML18:
    """Seeded weights, and seeded biases (the init's are zero, which would
    leave every bias path untested)."""
    g = torch.Generator().manual_seed(seed)
    model = ResNetRML18(frame_len=frame_len, dtype=dtype, generator=g).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
    return model


def _frames(seed: int, n: int = BATCH, t: int = T_SMALL) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, 2, t)).astype(np.float32))


def _gap(want: torch.Tensor, labels: torch.Tensor) -> float:
    """The widest gap of a served label's reference logit below the best."""
    return float((want.max(-1).values - want.gather(-1, labels.long()[:, None])[:, 0]).max())


def test_published_counts():
    m = macs_per_frame()
    assert m["stacks"] == 25_853_952 and sum(m.values()) == 25_938_944
    assert sum(p.numel() for p in ResNetRML18().parameters()) == 165_144
    stack1 = macs_per_frame(stacks=1)["stacks"]
    assert stack1 == 12_648_448


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_module_float32_equals_reference(seed):
    model, x = _model(seed), _frames(seed)
    want = ref.logits(model.state_dict(), x)
    with torch.no_grad():
        got = model(x)
    scale = float(want.abs().max())
    # Only the order of float32 sums differs (cuDNN-free conv1d against an
    # einsum over taps): a few ulps of the largest logit.
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_module_bf16_within_its_rounding(seed):
    model, x = _model(seed, dtype="bfloat16"), _frames(seed)
    want = ref.logits(model.state_dict(), x)
    with torch.no_grad():
        got = model(x)
    scale = float(want.abs().max())
    # Every layer's output is rounded to bf16 (8 significant bits, a step of
    # 2^-8 relative) and 29 layers follow one another: 4 % of the largest
    # logit holds the measured 0.3-1.3 %; float16 weights instead of bf16
    # would not be a lower precision, so the bound is on the result.
    assert float((got - want).abs().max()) <= 0.04 * scale
    assert _gap(want, got.argmax(-1)) <= 0.04 * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_chain_against_reference(seed):
    """The kernel's plain version then the head, at the kernel's widths but
    128-sample frames, within the bf16 tolerance of the module; and the
    classifier's labels are the head's on the plain map."""
    model, x = _model(seed), _frames(seed)
    state = model.state_dict()
    cw, hw = rc.make_chain_weights(state, "cpu"), rc.make_head_weights(state, "cpu")
    h = rc.residual_chain_bf16(x, cw)
    assert h.dtype == torch.bfloat16 and h.shape == (BATCH, T_SMALL // 64, 32)
    got = rc.head_logits(h, hw).float()
    want = ref.logits(state, x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 0.04 * scale
    labels = rc.make_resnet_classifier(state, "cpu")(x)
    assert torch.equal(labels, rc.head_labels(h, hw))
    assert _gap(want, labels) <= 0.04 * scale


def test_plain_stack0_is_exact():
    """Stack 0's projection sums two exact bf16 products, then the bias:
    the plain version's first map equals the kernel's arithmetic
    ``fma(xq, w1, xi * w0) + b`` in float64, rounded once to f32 then to
    bf16."""
    model, x = _model(3), _frames(3)
    cw = rc.make_chain_weights(model.state_dict(), "cpu")
    st = cw.stacks[0]
    xb = x.to(torch.bfloat16).double()
    exact = (xb[:, 0, :, None] * st.proj_w[:, 0].double()
             + xb[:, 1, :, None] * st.proj_w[:, 1].double()).float() + st.proj_b
    plain = (xb[:, 0, :, None].float() * st.proj_w[:, 0]
             + xb[:, 1, :, None].float() * st.proj_w[:, 1]) + st.proj_b
    assert torch.equal(plain.to(torch.bfloat16), exact.to(torch.bfloat16))


@pytest.mark.parametrize("stack", [0, 3, 5])
def test_weight_blob_holds_the_fragments(stack):
    """Reading the blob back in the kernel's fragment order gives each
    stack's bf16 weights and f32 biases."""
    model = _model(4)
    state = model.state_dict()
    cw = rc.make_chain_weights(state, "cpu")
    blob = cw.blob[stack * rc.STACK_BYTES:(stack + 1) * rc.STACK_BYTES]

    def bf16(a, b):
        return blob[a:b].view(torch.bfloat16).float()

    def f32(a, b):
        return blob[a:b].view(torch.float32)

    def unfrag(vals, k):
        v = vals.reshape(k // 16, 4, 32, 4)
        out = torch.empty(k, 32)
        lane = torch.arange(32)
        g, q = lane >> 2, lane & 3
        for ks in range(k // 16):
            for nt in range(4):
                for i, dk in enumerate((0, 1, 8, 9)):
                    out[16 * ks + 2 * q + dk, 8 * nt + g] = v[ks, nt, :, i]
        return out

    p = f"stacks.{stack}."
    proj = state[p + "proj.weight"][:, :, 0].to(torch.bfloat16).float()
    if stack == 0:
        assert torch.equal(f32(0, 256).reshape(2, 32), proj.T)
    else:
        assert torch.equal(unfrag(bf16(0, 2048), 32), proj.T)
    assert torch.equal(f32(2048, 2176), state[p + "proj.bias"])
    for i, (u, c) in enumerate([(0, "conv_a"), (0, "conv_b"), (1, "conv_a"), (1, "conv_b")]):
        w = state[f"{p}units.{u}.{c}.weight"].to(torch.bfloat16).float()     # (out, in, k)
        off = 2176 + i * 6144
        got = unfrag(bf16(off, off + 6144), 96)                            # [k * 32 + in, out]
        assert torch.equal(got, w.permute(2, 1, 0).reshape(96, 32))
        b_off = 26752 + i * 128
        assert torch.equal(f32(b_off, b_off + 128), state[f"{p}units.{u}.{c}.bias"])


def _cfg(ckpt_dir: str, *overrides: str) -> AmcConfig:
    return apply_overrides(AmcConfig(), ["device=cpu", *RESNET, f"train.checkpoint_dir={ckpt_dir}",
                                         *overrides])


def test_checkpoint_restores_by_architecture(tmp_path):
    model = _model(5)
    d = str(tmp_path / "ck")
    tckpt.save(d, 7, model.state_dict())
    cfg = _cfg(d, f"data.frame_len={T_SMALL}", "model.dtype=float32")
    got, step = tckpt.restore_model(d, cfg.model, T_SMALL, "cpu")
    assert step == 7 and isinstance(got, ResNetRML18) and not got.training
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    with pytest.raises(KeyError):                       # a VT-CNN2 restore finds no Conv1
        tckpt.restore(d)
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    v = str(tmp_path / "vt")
    tckpt.save(v, 1, VTCNN2(generator=torch.Generator().manual_seed(5)).state_dict())
    with pytest.raises(ValueError, match="Flax-layout"):
        tckpt.restore(v, arch="resnet_rml18")
    with pytest.raises(ValueError, match="unknown|known"):
        tckpt.restore_model(d, ModelConfig(arch="nosuch"), T_SMALL, "cpu")


def test_committed_checkpoint_is_the_seeded_model(tmp_path):
    from modulationdetectioncnn_torch.scripts import make_resnet_checkpoint as mk

    cfg = ModelConfig(arch="resnet_rml18", num_classes=24)
    got, step = tckpt.restore_model(mk.ASSET, cfg, 1024, "cpu")
    assert step == 0 and sum(p.numel() for p in got.parameters()) == 165_144
    out = mk.make(str(tmp_path / "ck"))
    with np.load(os.path.join(out, tckpt.PARAMS_FILE)) as a, \
            np.load(os.path.join(mk.ASSET, "0", tckpt.PARAMS_FILE)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_predictor_takes_the_module_on_the_cpu(tmp_path, dtype):
    model = _model(6)
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, model.state_dict())
    cfg = _cfg(d, f"data.frame_len={T_SMALL}", f"model.dtype={dtype}")
    predict = tpipe._make_predictor(cfg)
    assert predict.route == "module"
    x = _frames(6)
    model.dtype = getattr(torch, dtype)
    with torch.no_grad():
        want = model(x).argmax(-1).to(torch.int32)
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = predict(x)
    assert torch.equal(got, want)
    assert [r.name for r in profiler.spans()] == ["amc.classifier.predict"]
    assert profiler.counters() == {}


@pytest.mark.parametrize("frame_len,dtype,device,route", [
    (1024, "bfloat16", "cuda", "resnet_chain_bf16"),
    (1024, "float32", "cuda", "module"),
    (T_SMALL, "bfloat16", "cuda", "module"),
    (1024, "bfloat16", "cpu", "module"),
])
def test_route_by_device_dtype_and_widths(frame_len, dtype, device, route):
    """Deciding a route reads the model only: nothing runs on the card."""
    model = ResNetRML18(frame_len=frame_len, dtype=dtype)
    assert tpipe.resnet_route(model, torch.device(device)) == route


def test_classifier_spans_under_a_profiler():
    model, x = _model(7, frame_len=1024), _frames(7, n=2, t=1024)
    classify = rc.make_resnet_classifier(model.state_dict(), "cpu")
    profiler.reset()
    classify(x)
    assert profiler.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        labels = classify(x)
    assert [r.name for r in profiler.spans()] == ["amc.classifier.chain", "amc.classifier.head"]
    assert profiler.counters() == {}              # no device launches on the CPU
    assert labels.dtype == torch.int32 and labels.shape == (2,)


def test_stream_at_1024_sample_frames(tmp_path):
    """The stream path at ``stream.frame_len=1024`` hands the classifier the
    frames the unblocked front end gives, and its labels are the module's
    on them."""
    model = _model(8, frame_len=1024)
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, model.state_dict())
    cfg = _cfg(d, "data.frame_len=1024", "stream.frame_len=1024", "stream.frame_hop=1024",
               "model.dtype=bfloat16")
    sc = cfg.stream
    predict = tpipe._make_predictor(cfg)
    handed = []

    def spy(fr):
        handed.append(fr)
        return predict(fr)

    g = np.random.default_rng(8)
    x = torch.from_numpy(g.standard_normal((2, 1 << 16)).astype(np.float32))
    labels = tpipe.classify_stream_blocked(x, spy, sc)
    m = sc.num_subbands
    whole = tpipe.subband_frames(x, design_prototype(m, sc.taps_per_branch), sc)   # (M, F, 2, f)
    assert whole.shape[1:] == (4, 2, 1024) and labels.shape == (m, 4)
    fr = handed[0]
    nb = -(-x.shape[-1] // sc.block_len)
    fr = fr.reshape(nb, m, -1, 2, 1024).transpose(0, 1).reshape(m, -1, 2, 1024)[:, :4]
    torch.testing.assert_close(fr, whole, rtol=1e-5, atol=1e-5)
    model.dtype = torch.bfloat16
    with torch.no_grad():
        want = model(handed[0]).argmax(-1).to(torch.int32)
    want = want.reshape(nb, m, -1).transpose(0, 1).reshape(m, -1)[:, :4]
    assert torch.equal(labels, want)


def test_benchmark_reference_agrees(tmp_path):
    from amc_bench.reference.resnet_rml18 import ResNetModel

    model = _model(9)
    d = tckpt.save(str(tmp_path / "ck"), 1, model.state_dict())
    x = _frames(9)
    want = ref.logits(model.state_dict(), x)
    got = ResNetModel(os.path.join(d, tckpt.PARAMS_FILE), "cpu").logits(x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    low = ResNetModel(os.path.join(d, tckpt.PARAMS_FILE), "cpu", fp8=True).logits(x)
    assert float((low - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_sites_that_build_a_vtcnn2_refuse_another_architecture(tmp_path):
    from modulationdetectioncnn_torch import bench as tbench
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.scripts import r5_gap
    from modulationdetectioncnn_torch.train import loop
    from modulationdetectioncnn_torch.train.quant import quantize

    cfg = apply_overrides(AmcConfig(), ["device=cpu", *RESNET, "train.batch_size=8"])
    with pytest.raises(ValueError, match="resnet_rml18"):
        VTCNN2.from_config(cfg.model)
    with pytest.raises(ValueError, match="resnet_rml18"):
        loop.train(cfg, None, None)
    with pytest.raises(ValueError, match="VT-CNN2"):
        quantize(_model(10), _frames(10).numpy())
    with pytest.raises(ValueError, match="resnet_rml18"):
        tbench._frames_and_model(cfg, 4)
    with pytest.raises(ValueError, match="resnet_rml18"):
        r5_gap.grads(cfg)


def test_kernel_against_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    state = ResNetRML18(generator=torch.Generator().manual_seed(3)).state_dict()
    cw = rc.make_chain_weights(state, "cuda")
    x = torch.randn((4096, 2, rc.FRAME_LEN), generator=torch.Generator(device="cuda")
                    .manual_seed(3), device="cuda")
    rc.residual_chain_bf16.launches = 0
    for xb in (x, x[3:40], x[:1]):
        got, want = rc.residual_chain_bf16(xb, cw), rc.residual_chain_bf16_plain(xb, cw)
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= rc.MAP_TOL * scale
    assert rc.residual_chain_bf16.launches == 3
