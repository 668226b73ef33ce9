"""The port's Swin backbone against the JAX package's, on the CPU in f32.

One random flax tree per case, bridged by ``checkpoint/from_jax.py`` with no
rule of Swin's own:

- a tiny Swin (embed 32, depths (1, 1, 2, 1), window 4) on 42 x 83 frames, so
  that the patch embed pads, every stage's map pads to the window (11 x 21,
  6 x 11, 3 x 6, 2 x 3 tokens) and ``PatchMerging`` pads odd sides, with the
  shift mask on in every block of odd index;
- Swin-L's own widths, heads and window 12 (the 529-row bias table, shift 6)
  at depths (2, 2, 2, 2) on 72 x 104 frames, where every stage's map is smaller
  than the window.

res2..res5 element by element at rtol 1e-4 / atol 1e-5. Also: the relative
position index and the shift mask equal the JAX package's, the outputs are
``channels_last`` views, and train mode with drop-path draws from the
generator it is given (tests/test_torch_swin_train.py holds it against JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.backbones import swin as jax_swin
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models.backbones import swin
from vnext_tpu_torch.models.backbones import SWIN_PRESETS, make_backbone
from vnext_tpu_torch.models.layers import init_weights

from _torch_helpers import random_params, t

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
CASES = {
    "tiny": (dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4), window_size=4), (42, 83)),
    "swinL_widths": (dict(embed_dim=192, depths=(2, 2, 2, 2), num_heads=(6, 12, 24, 48), window_size=12),
                     (72, 104)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, (h, w) = CASES[request.param]
    images = np.random.RandomState(0).randn(2, h, w, 3).astype(np.float32)
    jmodel = jax_swin.SwinTransformer(**kw, drop_path_rate=0.0)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images)), seed=1)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, jnp.asarray(images))
    port = swin.SwinTransformer(**kw, drop_path_rate=0.0).eval()
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(t(images))
    return kw, params, port, want, got


def test_bridge_covers_every_leaf(case):
    kw, params, port, _, _ = case
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    w = kw["window_size"]
    assert tuple(state["layers_3_blocks_0.attn.relative_position_bias_table"].shape) == ((2 * w - 1) ** 2,
                                                                                          kw["num_heads"][3])
    assert "downsample_2.reduction.bias" not in state and "downsample_3.norm.weight" not in state


def test_stages_match_jax(case):
    kw, _, _, want, got = case
    assert set(got) == set(want) == {"res2", "res3", "res4", "res5"}
    for k, w in want.items():
        g = got[k]
        assert g.shape[1] == kw["embed_dim"] * 2 ** (int(k[3]) - 2)
        assert g.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [4, 7, 12])
def test_relative_position_index_matches_jax(window):
    np.testing.assert_array_equal(swin._relative_position_index(window),
                                  jax_swin._relative_position_index(window))


@pytest.mark.parametrize("hp, wp, window", [(8, 12, 4), (12, 24, 12), (36, 60, 12)])
def test_shift_mask_matches_jax(hp, wp, window):
    np.testing.assert_array_equal(swin._shift_attn_mask(hp, wp, window, window // 2),
                                  jax_swin._shift_attn_mask(hp, wp, window, window // 2))


def test_output_subset_and_train_mode():
    kw = CASES["tiny"][0]
    net = swin.SwinTransformer(**kw, out_features=("res3", "res4", "res5"))
    assert not hasattr(net, "out_norm0") and hasattr(net, "out_norm3")
    assert net.output_channels == {"res2": 32, "res3": 64, "res4": 128, "res5": 256}
    # train mode with drop-path runs, and its draws are a function of the generator
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    init_weights(net, 0)
    net.train()
    a, b = (net(x, torch.Generator().manual_seed(5)) for _ in range(2))
    assert set(a) == {"res3", "res4", "res5"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    with torch.no_grad():
        eval_out = net.eval()(x)
    assert any(not torch.equal(a[k], eval_out[k]) for k in a)
    bare = swin.SwinTransformer(**kw, drop_path_rate=0.0).train()
    assert set(bare(torch.zeros(1, 32, 32, 3))) == {"res2", "res3", "res4", "res5"}


def test_make_backbone_presets():
    net = make_backbone("swin", swin=SWIN_PRESETS["T"], out_features=("res3",), dtype=torch.float32)
    assert net.depths == (2, 2, 6, 2) and net.drop_path_rate == 0.2
    assert net.layers_0_blocks_0.window_size == 7 and net.layers_0_blocks_1.shift_size == 3
    with pytest.raises(ValueError, match="backbone_type"):
        make_backbone("vit", dtype=torch.float32)
