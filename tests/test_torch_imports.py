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
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.ops import encoder_epilogue, ms_deform_attn, stem_conv

from _torch_helpers import TINY_IDOL, cuda_device  # noqa: F401 (fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_MODULES = (ms_deform_attn, stem_conv, encoder_epilogue)


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
        "print(len(names), bad)\n"
    )
    count, bad = out.split(" ", 1)
    assert int(count) >= 15
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
        "from vnext_tpu_torch.models import idol\n"
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
    before = [m.KERNEL.launches for m in KERNEL_MODULES]
    for dtype in (torch.float32, torch.bfloat16):
        model = IDOL(**TINY_IDOL, dtype=dtype).eval()
        init_weights(model, seed=0)
        with torch.no_grad():
            out = model.inference(torch.randn(2, 64, 96, 3), torch.tensor([[64, 85]] * 2))
        assert all(torch.isfinite(v.float()).all() for v in out.values())
    assert [m.KERNEL.launches for m in KERNEL_MODULES] == before


def test_every_kernel_names_its_source_and_tpu_twin():
    for mod in KERNEL_MODULES:
        k = mod.KERNEL
        assert os.path.isfile(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            src_line = f.read().splitlines()[int(line) - 1]
        assert src_line.startswith("def _") and "kernel" in src_line, (k.replaces, src_line)


# ---------------------------------------------------------------- on the card
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
