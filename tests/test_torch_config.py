"""The port's config reader (``vnext_tpu_torch.config``) against the JAX package's.

For every yaml under ``configs/idol``, ``configs/seqformer`` and
``configs/minvis`` (``_BASE_`` included), ``get_cfg()`` + the project's
``add_*_config`` + ``merge_from_file`` must dump the same tree through either
package. Also: overrides, freezing and cloning behave alike, and the full-width
models the published files name (IDOL-Swin-L, SeqFormer-Swin-L, IDOL-R101)
build from the port's own node with the JAX model's parameter tree, key for
key and shape for shape (the port's built on the meta device: no memory, no
init; JAX's by ``jax.eval_shape``).
"""

import glob
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from vnext_tpu import config as jax_config
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.models.idol import build_idol_model as jax_build_idol
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu.models.seqformer import build_seqformer_model as jax_build_seqformer
from vnext_tpu_torch import config as port_config
from vnext_tpu_torch.models.idol import IDOL, idol_kwargs_from_cfg
from vnext_tpu_torch.models.seqformer import SeqFormer, seqformer_kwargs_from_cfg

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
EXTENDER = {"idol": "add_idol_config", "seqformer": "add_seqformer_config", "minvis": "add_maskformer_config"}
FILES = sorted(os.path.relpath(f, CONFIGS) for family in EXTENDER
               for f in glob.glob(os.path.join(CONFIGS, family, "**", "*.yaml"), recursive=True))


def _read(package, rel):
    cfg = package.get_cfg()
    getattr(package, EXTENDER[rel.split(os.sep)[0]])(cfg)
    cfg.merge_from_file(os.path.join(CONFIGS, rel))
    return cfg


def test_every_vis_config_is_listed():
    assert len(FILES) >= 13
    assert {"idol/ytvis19_swinL.yaml", "idol/ytvis19_r101.yaml", "seqformer/swin_ytvis.yaml",
            "minvis/ovis_r50_motion.yaml"} <= set(FILES)


@pytest.mark.parametrize("rel", FILES)
def test_config_dump_matches_jax(rel):
    assert _read(port_config, rel).dump() == _read(jax_config, rel).dump()


def test_defaults_and_overrides_match_jax():
    port, jax_cfg = port_config.get_cfg(), jax_config.get_cfg()
    assert port.dump() == jax_cfg.dump()
    overrides = ["MODEL.RESNETS.DEPTH", "101", "TPU.TEST_IMAGE_SIZE", "[360, 640]", "SOLVER.BASE_LR", "2e-4"]
    for cfg in (port, jax_cfg):
        cfg.merge_from_list(overrides)
    assert port.dump() == jax_cfg.dump()
    assert port.MODEL.RESNETS.DEPTH == 101 and port.TPU.TEST_IMAGE_SIZE == [360, 640]
    with pytest.raises(KeyError, match="NO_SUCH_KEY"):
        port.merge_from_list(["MODEL.NO_SUCH_KEY", "1"])
    with pytest.raises(ValueError, match="Type mismatch"):
        port.merge_from_list(["MODEL.RESNETS.DEPTH", "'deep'"])


def test_freeze_and_clone():
    cfg = port_config.get_cfg()
    port_config.add_idol_config(cfg)
    cfg.freeze()
    with pytest.raises(AttributeError, match="frozen"):
        cfg.MODEL.IDOL.NUM_CLASSES = 3
    other = cfg.clone()
    other.MODEL.IDOL.NUM_CLASSES = 3
    assert cfg.MODEL.IDOL.NUM_CLASSES == 80 and not other.is_frozen()


def _jax_shapes(model, method, *args):
    """{port key: shape} of the JAX model's parameter tree, by the weight bridge's rule."""
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, method=method))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        shape = tuple(leaf.shape)
        if keys[-1] == "kernel":
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        keys[-1] = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        out[".".join(keys)] = shape
    return out


@pytest.mark.parametrize("rel", ["idol/ytvis19_swinL.yaml", "idol/ytvis19_r101.yaml", "seqformer/swin_ytvis.yaml"])
def test_published_models_build_at_full_width(rel):
    cfg = _read(port_config, rel)
    jcfg = _read(jax_config, rel)
    if rel.startswith("idol"):
        with torch.device("meta"):
            port = IDOL(**idol_kwargs_from_cfg(cfg))
        x, sizes = jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]], jnp.int32)
        want = _jax_shapes(jax_build_idol(jcfg), JaxIDOL.inference, x, sizes)
    else:
        with torch.device("meta"):
            port = SeqFormer(**seqformer_kwargs_from_cfg(cfg))
        x, sizes = jnp.zeros((1, 2, 64, 64, 3)), jnp.asarray([[64, 64]], jnp.int32)
        want = _jax_shapes(jax_build_seqformer(jcfg), JaxSeqFormer.inference, x, sizes)
    assert port.dtype == torch.bfloat16
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    if "swin" in rel.lower():
        assert got["backbone.layers_2_blocks_17.attn.relative_position_bias_table"] == (23 * 23, 24)
        assert got["input_proj_0.conv.weight"] == (256, 384, 1, 1)
        assert got["input_proj_3.conv.weight"] == (256, 1536, 3, 3)
    else:
        assert "backbone.layer3_22.conv3.weight" in got
        assert got["input_proj_2.conv.weight"] == (256, 2048, 1, 1)
