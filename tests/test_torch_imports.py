"""The port's packaging rules, and each kernel against its plain version.

- ``vnext_tpu_torch`` never imports jax, flax or the JAX package;
- the kernel modules import with no ``nvcc`` and no ``triton``: the kernels are
  built only when a CUDA tensor first reaches a wrapper;
- CPU tensors run the plain versions and leave every launch counter where it was;
- the kernel library's name follows its sources, so an edit rebuilds;
- on a card (``cuda`` marker, skipped without one), each kernel launches once
  per call, agrees with its plain version, and a CUDA tensor it does not take
  raises instead of falling back. This file imports nothing of the JAX package,
  so the card tests run where flax is not installed:
  ``python -m pytest -m cuda tests/test_torch_imports.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vnext_tpu_torch import _build
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.instmove import InstMovePredictor
from vnext_tpu_torch.models.mask2former import MaskFormer
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.models.seqformer import SeqFormer
from vnext_tpu_torch.ops import encoder_epilogue, ms_deform_attn, stem_conv
from vnext_tpu_torch.tools import exp_dynstore

from _torch_helpers import TINY_IDOL, cuda_device  # noqa: F401 (fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_MODULES = (ms_deform_attn, stem_conv, encoder_epilogue)
# every launch counter of the package
COUNTERS = (ms_deform_attn.KERNEL, stem_conv.KERNEL, encoder_epilogue.KERNEL, ms_deform_attn.KERNEL_V9_FWD,
            ms_deform_attn.KERNEL_V9_BWD, ms_deform_attn.KERNEL_CM, ms_deform_attn.KERNEL_V6_FWD,
            ms_deform_attn.KERNEL_V6_BWD, ms_deform_attn.KERNEL_V7_FWD, ms_deform_attn.KERNEL_V8_FWD,
            exp_dynstore.KERNEL)


def _run(code, env=None):
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_package_never_imports_jax():
    out = _run(
        "import pkgutil, importlib, sys, vnext_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vnext_tpu_torch.__path__, 'vnext_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vnext_tpu'))\n"
        "print(len(names), ','.join(names), bad)\n"
    )
    count, names, bad = out.split(" ", 2)
    assert int(count) >= 15
    for name in ("models.seqformer", "engine.seqformer_inference", "tools.exp_dynstore", "models.mask2former",
                 "engine.minvis_inference", "models.instmove", "config", "config.cfgnode", "config.defaults",
                 "config.extensions", "models.backbones", "models.backbones.swin", "checkpoint.torch_import",
                 "data", "data.catalog", "data.datasets.ytvis", "data.datasets.synthetic", "data.transforms",
                 "data.dataset_mapper", "data.build", "structures.masks", "evaluation.rle", "evaluation.native",
                 "evaluation.ytvos_eval", "evaluation.ytvis_eval", "evaluation.evaluator", "evaluation.testing",
                 "checkpoint.checkpointer", "engine.launch", "utils.logger", "tools.train_net",
                 "tools.train_net_video", "ops.hungarian", "ops.point_sample", "utils.registry", "utils.env",
                 "utils.video_io", "utils.visualizer", "utils.analysis", "utils.memory", "engine.predictor",
                 "model_zoo", "model_zoo.model_zoo", "export", "export.api", "config.configurable",
                 "config.compat", "config.lazy", "tools.demo", "tools.export_model", "tools.analyze_model",
                 "tools.visualize_data", "tools.visualize_json_results", "tools.lazyconfig_train_net",
                 "tools.plain_train_net"):
        assert f"vnext_tpu_torch.{name}" in names.split(","), name
    assert bad.strip() == "[]"


def test_kernel_modules_import_without_nvcc_or_triton():
    env = {**os.environ, "PATH": os.path.dirname(sys.executable), "CUDA_HOME": "/nonexistent"}
    out = _run(
        "import importlib.abc, shutil, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] == 'triton': raise ImportError('triton blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from vnext_tpu_torch.ops import ms_deform_attn, stem_conv, encoder_epilogue\n"
        "from vnext_tpu_torch.models import idol, seqformer\n"
        "from vnext_tpu_torch.engine import seqformer_inference, minvis_inference\n"
        "from vnext_tpu_torch.models import mask2former, instmove\n"
        "from vnext_tpu_torch.models.backbones import swin\n"
        "from vnext_tpu_torch import config\n"
        "from vnext_tpu_torch.checkpoint import torch_import\n"
        "from vnext_tpu_torch.tools import exp_dynstore, train_net\n"
        "from vnext_tpu_torch import _build\n"
        "print(shutil.which('nvcc'), _build.load_library.cache_info().currsize)\n",
        env=env,
    )
    assert out.split() == ["None", "0"]


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    assert before == _build._digest()
    cu = next(tmp_path.glob("*.cu"))
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert _build._digest() != before


def test_cpu_model_leaves_launch_counters_alone():
    before = [k.launches for k in COUNTERS]
    for dtype in (torch.float32, torch.bfloat16):
        for impl in ("auto", "pallas"):
            model = IDOL(**TINY_IDOL, dtype=dtype, msda_impl=impl).eval()
            init_weights(model, seed=0)
            with torch.no_grad():
                out = model.inference(torch.randn(2, 64, 96, 3), torch.tensor([[64, 85]] * 2))
            assert all(torch.isfinite(v.float()).all() for v in out.values())
        model = SeqFormer(**TINY_IDOL, dtype=dtype).eval()
        init_weights(model, seed=0)
        with torch.no_grad():
            out = model.inference(torch.randn(1, 2, 64, 96, 3), torch.tensor([[64, 85]]))
        assert all(torch.isfinite(v.float()).all() for v in out.values())
    assert [k.launches for k in COUNTERS] == before


def test_cpu_minvis_and_instmove_leave_launch_counters_alone():
    """MaskFormer (K1 / K3 on the card) and InstMove (K2 in bf16) on CPU tensors
    run the plain versions, in f32 and bf16 alike."""
    before = [k.launches for k in COUNTERS]
    for dtype in (torch.float32, torch.bfloat16):
        model = MaskFormer(num_classes=5, hidden_dim=32, num_queries=8, dec_layers=3, enc_layers=1,
                           dim_feedforward=64, dtype=dtype).eval()
        init_weights(model, seed=0)
        motion = InstMovePredictor(memory_size=8, num_lstm_layers=2, lstm_channels=16, dtype=dtype).eval()
        init_weights(motion, seed=0)
        with torch.no_grad():
            out = model.inference(torch.randn(2, 64, 96, 3))
            pred = motion(torch.rand(2, 4, 32, 32, 1), torch.randn(2, 64, 64, 3))
        assert all(torch.isfinite(v.float()).all() for v in out.values())
        assert pred.shape == (2, 1, 32, 32, 1) and torch.isfinite(pred.float()).all()
    assert [k.launches for k in COUNTERS] == before


def test_cpu_swin_and_r101_models_leave_launch_counters_alone():
    """IDOL and SeqFormer on a tiny Swin and IDOL on ResNet-101 (MSRA layout)
    on CPU tensors: the plain versions, in f32 and bf16 alike."""
    before = [k.launches for k in COUNTERS]
    swin = (32, (1, 1, 2, 1), (2, 2, 4, 4), 4, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for model, args in (
                (IDOL(**TINY_IDOL, dtype=dtype, backbone_type="swin", swin=swin),
                 (torch.randn(2, 64, 96, 3), torch.tensor([[64, 85]] * 2))),
                (SeqFormer(**TINY_IDOL, dtype=dtype, backbone_type="swin", swin=swin),
                 (torch.randn(1, 2, 64, 96, 3), torch.tensor([[64, 85]]))),
                (IDOL(**TINY_IDOL, dtype=dtype, backbone_depth=101, stride_in_1x1=True),
                 (torch.randn(1, 64, 96, 3), torch.tensor([[64, 85]])))):
            init_weights(model, seed=0)
            with torch.no_grad():
                out = model.eval().inference(*args)
            assert all(torch.isfinite(v.float()).all() for v in out.values())
    assert [k.launches for k in COUNTERS] == before


def test_every_kernel_names_its_source_and_tpu_twin():
    for mod in KERNEL_MODULES:
        k = mod.KERNEL
        assert os.path.isfile(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            src_line = f.read().splitlines()[int(line) - 1]
        assert src_line.startswith("def _") and "kernel" in src_line, (k.replaces, src_line)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_entry_point_runs_on_the_card_by_default(cuda_device, tmp_path):
    """The entry point with its defaults' MODEL.DEVICE ("tpu", read as the card):
    --eval-only at ytvis19_r50 width on a small synthetic dataset runs K1 / K2 /
    K3, and one train step (one clip) runs K4 / K5 / K2 with the model on the
    card. (The quick-schedule config's widths, hidden 64 in 4 heads, are not
    the kernels': it runs on the CPU.)"""
    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
    from vnext_tpu_torch.tools import train_net

    register_synthetic_ytvis("card_entry_point", root=str(tmp_path / "data"), num_videos=2, num_frames=3)
    # the synthetic dataset's 3 categories: every label the model predicts has one
    args = ["--config-file", os.path.join(REPO, "configs", "idol", "ytvis19_r50.yaml"), "MODEL.WEIGHTS", "",
            "MODEL.IDOL.NUM_CLASSES", "3", "DATASETS.TEST", "('card_entry_point',)",
            "DATASETS.TRAIN", "('card_entry_point',)", "OUTPUT_DIR", str(tmp_path / "out")]
    before = {k.name: k.launches for k in COUNTERS}
    results = train_net.main(["--eval-only", *args])
    moved = {k.name: k.launches - before[k.name] for k in COUNTERS if k.launches != before[k.name]}
    assert set(moved) == {"ms_deform_attn_fwd", "stem_conv", "encoder_epilogue"}, moved
    assert set(results["card_entry_point"]["segm"]) >= {"AP", "AP50", "AR@100"}

    before = {k.name: k.launches for k in COUNTERS}
    trainer = train_net.main([*args, "SOLVER.IMS_PER_BATCH", "1", "SOLVER.MAX_ITER", "1", "TEST.EVAL_PERIOD", "0"])
    moved = {k.name: k.launches - before[k.name] for k in COUNTERS if k.launches != before[k.name]}
    assert moved["ms_deform_attn_v9_fwd"] == 24 and moved["ms_deform_attn_v9_bwd"] == 24, moved
    assert next(trainer.state.model.parameters()).is_cuda
    assert (tmp_path / "out" / "last_checkpoint").read_text() == "model_0000000.pth"


@pytest.mark.cuda
def test_train_net_video_runs_on_the_card_by_default(cuda_device, tmp_path):
    """MinVIS's entry point with its defaults' MODEL.DEVICE ("tpu", read as the
    card) at ovis_r50 width on a small synthetic dataset: --eval-only runs K1 /
    K2 / K3, and one train step (one clip, key + reference frame) runs K4 / K5
    / K2 = 6 / 6 / 1 with the model on the card. (The quick-schedule config's
    hidden 64 in 8 heads is not the kernels' width: it runs on the CPU.)"""
    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
    from vnext_tpu_torch.tools import train_net_video

    register_synthetic_ytvis("card_entry_point_video", root=str(tmp_path / "data"), num_videos=2, num_frames=3)
    args = ["--config-file", os.path.join(REPO, "configs", "minvis", "ovis_r50.yaml"),
            "MODEL.MASK_FORMER.NUM_CLASSES", "3", "DATASETS.TEST", "('card_entry_point_video',)",
            "DATASETS.TRAIN", "('card_entry_point_video',)", "OUTPUT_DIR", str(tmp_path / "out")]
    before = {k.name: k.launches for k in COUNTERS}
    results = train_net_video.main(["--eval-only", *args])
    moved = {k.name: k.launches - before[k.name] for k in COUNTERS if k.launches != before[k.name]}
    assert set(moved) == {"ms_deform_attn_fwd", "stem_conv", "encoder_epilogue"}, moved
    assert set(results["card_entry_point_video"]["segm"]) >= {"AP", "AP50", "AR@100"}

    before = {k.name: k.launches for k in COUNTERS}
    trainer = train_net_video.main([*args, "SOLVER.IMS_PER_BATCH", "1", "SOLVER.MAX_ITER", "1",
                                    "TEST.EVAL_PERIOD", "0"])
    moved = {k.name: k.launches - before[k.name] for k in COUNTERS if k.launches != before[k.name]}
    assert moved["ms_deform_attn_v9_fwd"] == 6 and moved["ms_deform_attn_v9_bwd"] == 6, moved
    assert next(trainer.state.model.parameters()).is_cuda
    assert (tmp_path / "out" / "last_checkpoint").read_text() == "model_0000000.pth"


def _write_r50_pkl(path, seed):
    """A torchvision-form detectron2 ``.pkl`` (``{"model", "__author__"}``, d2
    names) of a seeded ResNet-50; returns its state under those names."""
    import pickle

    from vnext_tpu_torch.checkpoint.torch_import import to_reference_names
    from vnext_tpu_torch.models.backbones.resnet import ResNet

    wrapper = torch.nn.Module()
    wrapper.backbone = ResNet(depth=50)
    init_weights(wrapper, seed)
    prefix = "detr.detr.backbone.0.backbone."
    d2 = {k[len(prefix):]: v.numpy() for k, v in to_reference_names(wrapper.state_dict(), "idol").items()}
    with open(path, "wb") as f:
        pickle.dump({"model": d2, "__author__": "torchvision", "matching_heuristics": True}, f)
    return d2


@pytest.mark.cuda
def test_pkl_backbone_loads_onto_the_card(cuda_device, tmp_path):
    """IDOL-R50 built on the card from the COCO-pretrain yaml takes a
    torchvision-form ``R-50.pkl`` through ``load_weights``: every backbone
    tensor on the card equals the file's."""
    from vnext_tpu_torch.checkpoint.checkpointer import load_weights
    from vnext_tpu_torch.checkpoint.torch_import import to_reference_names
    from vnext_tpu_torch.config import add_idol_config, get_cfg
    from vnext_tpu_torch.models.idol import build_idol_model

    d2 = _write_r50_pkl(tmp_path / "R-50.pkl", seed=7)
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, "configs", "idol", "coco_pretrain", "r50_coco_sequence.yaml"))
    model = build_idol_model(cfg, device=cuda_device, seed=0)
    load_weights(str(tmp_path / "R-50.pkl"), model)
    backbone = {k: v for k, v in model.state_dict().items() if k.startswith("backbone.")}
    ref = to_reference_names(backbone, "idol")
    assert len(ref) == len(d2)
    for k, v in ref.items():
        want = torch.from_numpy(d2[k[len("detr.detr.backbone.0.backbone."):]])
        assert v.is_cuda and torch.equal(v.cpu(), want.to(v.dtype)), k


@pytest.mark.cuda
def test_coco_pretrain_step_runs_on_the_card(cuda_device, tmp_path):
    """IDOL's COCO-pretrain stage through the entry point on the card at the
    yaml's width (``INPUT.COCO_PRETRAIN True``, a synthetic COCO set at 480x640,
    the ``.pkl`` ImageNet init): one step of one pseudo-clip runs K4 / K5 / K2 =
    24 / 24 / 2 with finite losses."""
    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco, register_synthetic_ytvis
    from vnext_tpu_torch.tools import train_net

    _write_r50_pkl(tmp_path / "R-50.pkl", seed=7)
    register_synthetic_coco("card_coco_pretrain", root=str(tmp_path / "coco"), num_images=2, h=480, w=640)
    register_synthetic_ytvis("card_coco_pretrain_eval", root=str(tmp_path / "ytvis"), num_videos=1, num_frames=2)
    args = ["--config-file", os.path.join(REPO, "configs", "idol", "coco_pretrain", "r50_coco_sequence.yaml"),
            "INPUT.COCO_PRETRAIN", "True", "MODEL.WEIGHTS", str(tmp_path / "R-50.pkl"), "MODEL.IDOL.NUM_CLASSES", "3",
            "DATASETS.TRAIN", "('card_coco_pretrain',)", "DATASETS.TEST", "('card_coco_pretrain_eval',)",
            "SOLVER.IMS_PER_BATCH", "1", "SOLVER.MAX_ITER", "1", "OUTPUT_DIR", str(tmp_path / "out")]
    counters = (ms_deform_attn.KERNEL_V9_FWD, ms_deform_attn.KERNEL_V9_BWD, stem_conv.KERNEL)
    before = [k.launches for k in counters]
    trainer = train_net.main(args)
    hist = trainer.storage.histories()
    assert all(np.isfinite(hist[k].values()).all() for k in hist if k.startswith("loss_"))
    assert next(trainer.state.model.parameters()).is_cuda
    # K2 twice in the step (key and reference), once in the evaluation after training (one clip of 2 frames),
    # which runs K1 / K3 and no K4 / K5
    moved = [k.launches - b for k, b in zip(counters, before)]
    assert moved == [24, 24, 3], moved


BF16_ULP = 2.0 ** -7
LEVELS = ((12, 16), (6, 8), (3, 4), (2, 2))


def _msda_args(dev, box, q=50, b=2, m=8, d=32, p=4):
    rng = np.random.RandomState(13 + box)
    s, l = sum(h * w for h, w in LEVELS), len(LEVELS)
    value = rng.randn(b, s, m, d)
    if box:
        ref = np.concatenate([rng.rand(b, q, l, 2), rng.rand(b, q, l, 2) * 0.5 + 0.05], -1)
    else:
        ref = rng.rand(b, q, l, 2)
    off = rng.randn(b, q, m, l, p, 2) * 3.0
    off[..., 0, :] = np.round(off[..., 0, :])                        # on pixel centres
    far = rng.rand(b, q, m, l, p) < 0.1
    off[far] = 60.0                                                   # outside every level
    logits = rng.randn(b, q, m, l * p) * 2.0
    bf16 = torch.bfloat16
    return (torch.tensor(value, dtype=bf16, device=dev), LEVELS,
            torch.tensor(off, dtype=bf16, device=dev),
            torch.tensor(ref, dtype=torch.float32, device=dev),
            torch.tensor(logits, dtype=bf16, device=dev))


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max()), float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["point", "box"])
def test_msda_kernel_matches_plain(cuda_device, box):
    args = _msda_args(cuda_device, box)
    before = ms_deform_attn.KERNEL.launches
    got = ms_deform_attn.ms_deform_attn(*args)
    want = ms_deform_attn.ms_deform_attn_plain(*args)
    assert ms_deform_attn.KERNEL.launches == before + 1
    err, scale = _max_err(got, want)
    # both round the same f32 sums to bf16 once: one bf16 ulp at the largest output
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_stem_kernel_matches_plain(cuda_device):
    rng = np.random.RandomState(3)
    x, k = rng.randn(2, 40, 72, 3), rng.randn(7, 7, 3, 64) * 0.1
    scale, bias = rng.rand(64) + 0.5, rng.randn(64) * 0.1
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device) for a in (x, k, scale, bias)]
    before = stem_conv.KERNEL.launches
    got = stem_conv.stem_conv7x7s2_bn_relu(*args)
    want = stem_conv.stem_conv_plain(*args)
    assert stem_conv.KERNEL.launches == before + 1
    err, scale_max = _max_err(got, want)
    # exact bf16 x bf16 products summed in f32 in two orders, one bf16 rounding each
    assert err <= BF16_ULP * scale_max, err


@pytest.mark.cuda
def test_encoder_epilogue_kernel_matches_plain(cuda_device):
    rng = np.random.RandomState(2)
    c, f = 256, 1024                                                  # the kernel's d_model
    a, src = rng.randn(2, 200, c) * 0.5, rng.randn(2, 200, c)
    params = (rng.rand(c) + 0.5, rng.randn(c) * 0.1, rng.randn(f, c) / 16, rng.randn(f) * 0.1,
              rng.randn(c, f) / 32, rng.randn(c) * 0.1, rng.rand(c) + 0.5, rng.randn(c) * 0.1)
    a, src = (torch.tensor(x, dtype=torch.bfloat16, device=cuda_device) for x in (a, src))
    params = [torch.tensor(x, dtype=torch.float32, device=cuda_device) for x in params]
    before = encoder_epilogue.KERNEL.launches
    got = encoder_epilogue.encoder_epilogue(a, src, *params)
    want = encoder_epilogue.encoder_epilogue_plain(a, src, *params)
    assert encoder_epilogue.KERNEL.launches == before + 1
    err, scale = _max_err(got, want)
    # the final rounding plus the plain version's bf16 roundings of both products
    assert err <= 2 * BF16_ULP * scale, err


@pytest.mark.cuda
def test_cuda_tensors_the_kernel_does_not_take_raise(cuda_device):
    value, levels, off, ref, logits = _msda_args(cuda_device, False)
    before = ms_deform_attn.KERNEL.launches
    with pytest.raises(TypeError, match="bfloat16"):
        ms_deform_attn.ms_deform_attn(value.float(), levels, off, ref, logits)
    with pytest.raises(ValueError, match="D == 32"):
        ms_deform_attn.ms_deform_attn(value[..., :16].contiguous(), levels, off, ref, logits)
    assert ms_deform_attn.KERNEL.launches == before


@pytest.mark.cuda
def test_inference_only_kernels_raise_under_grad(cuda_device):
    """K1's fused entry and K3 have no backward (as on the TPU): under autograd
    they raise instead of returning a tensor that silently drops the gradient."""
    value, levels, off, ref, logits = _msda_args(cuda_device, False)
    before = (ms_deform_attn.KERNEL.launches, encoder_epilogue.KERNEL.launches)
    with pytest.raises(RuntimeError, match="inference-only"):
        ms_deform_attn.ms_deform_attn(value.requires_grad_(), levels, off, ref, logits)
    with torch.no_grad():
        ms_deform_attn.ms_deform_attn(value, levels, off, ref, logits)
    rng = np.random.RandomState(4)
    a, src = (torch.tensor(rng.randn(1, 64, 256), dtype=torch.bfloat16, device=cuda_device) for _ in range(2))
    params = [torch.tensor(x, dtype=torch.float32, device=cuda_device) for x in (
        rng.rand(256) + 0.5, rng.randn(256) * 0.1, rng.randn(1024, 256) / 16, rng.randn(1024) * 0.1,
        rng.randn(256, 1024) / 32, rng.randn(256) * 0.1, rng.rand(256) + 0.5, rng.randn(256) * 0.1)]
    params[2].requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        encoder_epilogue.encoder_epilogue(a, src, *params)
    assert (ms_deform_attn.KERNEL.launches, encoder_epilogue.KERNEL.launches) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_stem_kernel_backward_matches_plain(cuda_device):
    """K2's autograd function (kernel forward, f32 linearization backward)
    against the plain version's autograd, on an input bf16 holds exactly so that
    both linearize at the same point."""
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(2, 32, 48, 3), device=cuda_device).to(torch.bfloat16).float()
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (rng.randn(7, 7, 3, 64) * 0.1, rng.rand(64) + 0.5, rng.randn(64) * 0.1)]
    g = torch.tensor(rng.randn(2, 16, 24, 64), dtype=torch.bfloat16, device=cuda_device)
    kern = [a.clone().requires_grad_() for a in args]
    plain = [a.clone().requires_grad_() for a in args]
    before = stem_conv.KERNEL.launches
    stem_conv.stem_conv7x7s2_bn_relu(x, *kern).backward(g)
    stem_conv.stem_conv_plain(x, *plain).backward(g)
    assert stem_conv.KERNEL.launches == before + 1
    for a, b in zip(kern, plain):
        # the same f32 products summed in other orders; dkernel rounded to bf16 on both sides
        assert float((a.grad - b.grad).norm() / b.grad.norm()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("q", [50, 300])
def test_msda_train_kernels_match_plain(cuda_device, q):
    """K4 (forward) and K5 (backward) of the standard entry against the plain
    core and its autograd, with samples on pixel centres and outside the levels."""
    rng = np.random.RandomState(q)
    b, m, d, p = 2, 8, 32, 4
    s, l = sum(h * w for h, w in LEVELS), len(LEVELS)
    wh = np.asarray([[w, h] for h, w in LEVELS])
    loc = rng.rand(b, q, m, l, p, 2) * 1.2 - 0.1
    loc[:, :, :, :, 0] = (rng.randint(0, 100, (b, q, m, l, 2)) % wh + 0.5) / wh
    loc[rng.rand(b, q, m, l, p) < 0.05] = 3.0
    value = torch.tensor(rng.randn(b, s, m, d), dtype=torch.bfloat16, device=cuda_device)
    loc = torch.tensor(loc, dtype=torch.float32, device=cuda_device)
    attn = torch.softmax(torch.tensor(rng.randn(b, q, m, l * p), device=cuda_device).float(), -1)
    attn = attn.to(torch.bfloat16).view(b, q, m, l, p)
    grad = torch.tensor(rng.randn(b, q, m * d), dtype=torch.bfloat16, device=cuda_device)
    before = (ms_deform_attn.KERNEL_V9_FWD.launches, ms_deform_attn.KERNEL_V9_BWD.launches)
    leaves = [x.clone().requires_grad_() for x in (value, loc, attn)]
    out = ms_deform_attn.ms_deform_attn_standard(leaves[0], LEVELS, leaves[1], leaves[2], "pallas_v9")
    out.backward(grad)
    assert (ms_deform_attn.KERNEL_V9_FWD.launches, ms_deform_attn.KERNEL_V9_BWD.launches) == \
        (before[0] + 1, before[1] + 1)
    want = ms_deform_attn.ms_deform_attn_core_plain(value, LEVELS, loc, attn)
    wants = ms_deform_attn.ms_deform_attn_grad_plain(value, LEVELS, loc, attn, grad)
    # bf16 output: one ulp at the largest element (the same f32 sums rounded once,
    # in other orders)
    err, scale = _max_err(out.detach(), want)
    assert out.dtype == torch.bfloat16 and err <= BF16_ULP * scale, err
    # dvalue and dattn, element by element: one bf16 ulp of |want| plus 2^-16 of
    # the element's sum of |terms| (f32 sums of the same products in other
    # orders, dvalue's atomics in one that changes from run to run). Their terms
    # attn * w_corner * g and g * w_corner * v have their only signs in g and v.
    abs_sums = ms_deform_attn.ms_deform_attn_grad_plain(value.abs(), LEVELS, loc, attn, grad.abs())
    for i in (0, 2):
        got, w, limit = leaves[i].grad.float(), wants[i].float(), abs_sums[i].float()
        assert leaves[i].grad.dtype == torch.bfloat16
        excess = (got - w).abs() - (BF16_ULP * w.abs() + 2.0 ** -16 * limit)
        assert float(excess.max()) <= 0.0, float(excess.max())
    # dloc is f32: sums of the same products in other orders
    err, scale = _max_err(leaves[1].grad, wants[1])
    assert leaves[1].grad.dtype == torch.float32 and err <= 1e-5 * scale, err


@pytest.mark.cuda
def test_msda_channel_major_kernel_matches_plain(cuda_device):
    """K4b: the channel-major entry with precomputed locations against its plain
    version, with samples on pixel centres and outside the levels; inference-only."""
    rng = np.random.RandomState(21)
    b, m, d, p, q = 2, 8, 32, 4, 50
    s, l = sum(h * w for h, w in LEVELS), len(LEVELS)
    wh = np.asarray([[w, h] for h, w in LEVELS])
    loc = rng.rand(b, m, l, p, 2, q) * 1.2 - 0.1
    loc[:, :, :, 0] = (rng.randint(0, 100, (b, m, l, 2, q)) % wh[None, None, :, :, None] + 0.5) \
        / wh[None, None, :, :, None]
    loc[..., :5] = 3.0
    value_t = torch.tensor(rng.randn(b, m * d, s), dtype=torch.bfloat16, device=cuda_device)
    loc_cm = torch.tensor(loc, dtype=torch.float32, device=cuda_device)
    attn = torch.softmax(torch.tensor(rng.randn(b, m, l * p, q), device=cuda_device).float(), 2)
    attn_cm = attn.to(torch.bfloat16).view(b, m, l, p, q).contiguous()
    before = ms_deform_attn.KERNEL_CM.launches
    got = ms_deform_attn.ms_deform_attn_cm(value_t, LEVELS, loc_cm, attn_cm)
    want = ms_deform_attn.ms_deform_attn_cm_plain(value_t, LEVELS, loc_cm, attn_cm)
    assert ms_deform_attn.KERNEL_CM.launches == before + 1
    assert got.shape == (b, m * d, q) and got.dtype == torch.bfloat16
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err
    with pytest.raises(RuntimeError, match="inference-only"):
        ms_deform_attn.ms_deform_attn_cm(value_t.clone().requires_grad_(), LEVELS, loc_cm, attn_cm)


@pytest.mark.cuda
@pytest.mark.parametrize("starts", [(0, 1, 2, 0), (14, 13, 20, 3), (-1, -13, 5, 100)])
def test_dynstore_kernel_matches_plain(cuda_device, starts):
    """K9: the same f32 additions in the same order of steps, so equal bit for bit."""
    x, r = exp_dynstore.probe_inputs(starts, seed=abs(starts[1]))
    r[1] = torch.from_numpy(np.random.RandomState(5).randn(*r.shape[1:]).astype(np.float32) * 9.0)
    before = exp_dynstore.KERNEL.launches
    got = exp_dynstore.dynstore(x.to(cuda_device), r.to(cuda_device))
    assert exp_dynstore.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), exp_dynstore.dynstore_plain(x, r))


@pytest.mark.cuda
@pytest.mark.parametrize("impl, route", [("pallas", "v6"), ("pallas_v7", "v7"), ("pallas_v8", "v8")])
def test_selector_routes_count_beside_k4_k5(cuda_device, impl, route):
    """A v6 / v7 / v8 route runs K4 forward and K5 backward and counts on its own
    counter too; its backward is the v6 backward's."""
    rng = np.random.RandomState(22)
    b, m, d, p, q = 2, 8, 32, 4, 40
    s, l = sum(h * w for h, w in LEVELS), len(LEVELS)
    value = torch.tensor(rng.randn(b, s, m, d), dtype=torch.bfloat16, device=cuda_device)
    loc = torch.tensor(rng.rand(b, q, m, l, p, 2), dtype=torch.float32, device=cuda_device)
    attn = torch.softmax(torch.tensor(rng.randn(b, q, m, l * p), device=cuda_device).float(), -1)
    attn = attn.to(torch.bfloat16).view(b, q, m, l, p)
    fwd = getattr(ms_deform_attn, f"KERNEL_{route.upper()}_FWD")
    counters = (ms_deform_attn.KERNEL_V9_FWD, ms_deform_attn.KERNEL_V9_BWD, fwd, ms_deform_attn.KERNEL_V6_BWD)
    before = [k.launches for k in counters]
    leaves = [x.clone().requires_grad_() for x in (value, loc, attn)]
    out = ms_deform_attn.ms_deform_attn_standard(leaves[0], LEVELS, leaves[1], leaves[2], impl)
    out.float().sum().backward()
    assert [k.launches - n for k, n in zip(counters, before)] == [1, 1, 1, 1]
    want = ms_deform_attn.ms_deform_attn_core_plain(value, LEVELS, loc, attn)
    err, scale = _max_err(out.detach(), want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["IDOL", "SeqFormer"])
def test_export_on_the_card_runs_the_kernels(cuda_device, tmp_path, arch):
    """A one-layer model at the kernels' widths (hidden 256 in 8 heads, d_ffn
    1024, ResNet-18, bf16) exported on the card: the graph holds the vnext::
    operators, and the program loaded from its .pt2 launches exactly those
    kernels and gives the eager model's outputs bit for bit (the same kernels
    and library calls in the same order)."""
    from vnext_tpu_torch.export import export_program, load_exported, save_exported, vnext_op_counts
    from vnext_tpu_torch.tools.export_model import example_inputs, inference_fn

    cls = IDOL if arch == "IDOL" else SeqFormer
    model = cls(num_classes=5, num_queries=20, enc_layers=1, dec_layers=1, backbone_depth=18,
                dtype=torch.bfloat16)
    init_weights(model, 0)
    model = model.to(cuda_device).eval()
    images, sizes = example_inputs(model, 2, 64, 96, cuda_device)
    images = torch.randn(images.shape, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    ops = vnext_op_counts(export_program(inference_fn(model), (images, sizes)))
    want = {"msda_fwd": 2, "stem_conv": 1, "encoder_epilogue": 1}
    if arch == "SeqFormer":
        want = {"msda_fwd": 1, "msda_fwd_loc": 1, "stem_conv": 1, "encoder_epilogue": 1}
    assert ops == want
    path = str(tmp_path / "m.pt2")
    save_exported(export_program(inference_fn(model), (images, sizes)), path)
    program = load_exported(path).module()
    before = {k.name: k.launches for k in COUNTERS}
    with torch.no_grad():
        got = program(images, sizes)
        torch.cuda.synchronize()
        moved = {k.name: k.launches - before[k.name] for k in COUNTERS if k.launches != before[k.name]}
        eager = inference_fn(model)(images, sizes)
    kernel = {"msda_fwd": "ms_deform_attn_fwd", "msda_fwd_loc": "ms_deform_attn_v9_fwd", "stem_conv": "stem_conv",
              "encoder_epilogue": "encoder_epilogue"}
    assert moved == {kernel[k]: n for k, n in want.items()}
    for k in eager:
        assert torch.equal(got[k], eager[k]), k
