"""The port's reference-checkpoint importer against the JAX package's, on the CPU.

For each family the port serves (IDOL-R50, IDOL-Swin, SeqFormer-Swin,
MinVIS-R50, at the tiny widths of their parity tests), a random flax tree is
bridged into the port, and the port's state written out under the reference's
names (``to_reference_names``, ``nn.MultiheadAttention``'s q / k / v packed
into ``in_proj``) with the ``module.`` prefix of a DDP checkpoint, one tensor
dropped and one stray tensor added. Then:

- the port's converter + ``apply_to_model`` and the JAX package's converter +
  ``apply_to_params`` + the weight bridge give the same state, bit for bit,
  and the same report (matched count; missing and unused keys, the JAX paths
  under the bridge's names);
- the port's state round-trips exactly, with a clean report when nothing is
  dropped;
- the family is detected alike, a ``.pth`` file loads through
  ``load_reference_weights``, and a shape mismatch raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.checkpoint import torch_import as jax_import
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.models.mask2former import MaskFormer as JaxMaskFormer
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu_torch.checkpoint import torch_import
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.models.mask2former import MaskFormer
from vnext_tpu_torch.models.seqformer import SeqFormer

from _torch_helpers import TINY_IDOL, random_params

SWIN = (32, (1, 1, 2, 1), (2, 2, 4, 4), 4, 0.0)
TINY_SEQ = dict(num_classes=5, hidden_dim=32, num_queries=12, nheads=4, dim_feedforward=64,
                enc_layers=1, dec_layers=2)
TINY_M2F = dict(num_classes=5, hidden_dim=32, num_queries=8, dec_layers=3, enc_layers=1, dim_feedforward=64)
BB = "detr.detr.backbone.0.backbone."


def _idol(backbone):
    extra = {} if backbone == "r50" else dict(backbone_type="swin", swin=SWIN)
    jmodel = JaxIDOL(**TINY_IDOL, max_insts=8, msda_impl="jnp", **extra)
    x, s = jnp.zeros((1, 64, 96, 3)), jnp.asarray([[64, 96]], jnp.int32)
    return (jmodel, lambda: jmodel.init(jax.random.PRNGKey(0), x, s, method=JaxIDOL.inference),
            lambda: IDOL(**TINY_IDOL, **extra), dict(dec_layers=2, enc_layers=1, num_feature_levels=4))


def _seqformer():
    jmodel = JaxSeqFormer(**TINY_SEQ, msda_impl="jnp", backbone_type="swin", swin=SWIN)
    x, s = jnp.zeros((1, 2, 64, 96, 3)), jnp.asarray([[64, 96]], jnp.int32)
    return (jmodel, lambda: jmodel.init(jax.random.PRNGKey(0), x, s, method=JaxSeqFormer.inference),
            lambda: SeqFormer(**TINY_SEQ, backbone_type="swin", swin=SWIN),
            dict(dec_layers=2, enc_layers=1, num_feature_levels=4))


def _minvis():
    jmodel = JaxMaskFormer(**TINY_M2F, msda_impl="jnp")
    x, s = jnp.zeros((1, 64, 96, 3)), jnp.asarray([[64, 96]], jnp.int32)
    return (jmodel, lambda: jmodel.init(jax.random.PRNGKey(0), x, s, method=JaxMaskFormer.inference),
            lambda: MaskFormer(**TINY_M2F), dict(dec_layers=3, enc_layers=1))


# family -> (model maker, reference family, a tensor to drop, a stray tensor's name)
CASES = {
    "idol_r50": (lambda: _idol("r50"), "idol", "detr.detr.query_embed.weight", BB + "res6.0.conv1.weight"),
    "idol_swin": (lambda: _idol("swin"), "idol", BB + "layers.2.blocks.1.attn.relative_position_bias_table",
                  BB + "norm0.weight"),
    "seqformer_swin": (_seqformer, "seqformer", "detr.detr.transformer.decoder.layers.1.self_attn_box.in_proj_bias",
                       BB + "norm0.bias"),
    "minvis_r50": (_minvis, "minvis", "sem_seg_head.predictor.transformer_self_attention_layers.2.self_attn"
                   ".in_proj_weight", "sem_seg_head.pixel_decoder.transformer.encoder.layers.1.norm1.weight"),
}
PORT_CONVERTER = {"idol": torch_import.convert_idol_checkpoint, "seqformer": torch_import.convert_seqformer_checkpoint,
                  "minvis": torch_import.convert_minvis_checkpoint}
JAX_CONVERTER = {"idol": jax_import.convert_idol_checkpoint, "seqformer": jax_import.convert_seqformer_checkpoint,
                 "minvis": jax_import.convert_minvis_checkpoint}


def _port_key(path):
    """A flax path under the weight bridge's names."""
    *head, leaf = path
    return ".".join(list(head) + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, family, drop, stray = CASES[request.param]
    jmodel, init, make_port, kwargs = make()
    params = random_params(init, seed=1)
    port = make_port().eval()
    load_from_jax(port, params)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    ref = {f"module.{k}": v for k, v in torch_import.to_reference_names(state, family).items()}
    return dict(family=family, drop=drop, stray=stray, init=init, make_port=make_port, kwargs=kwargs,
                state=state, ref=ref)


def _fresh(case):
    port = case["make_port"]()
    init_weights(port, seed=7)
    return port.eval()


def test_round_trip_is_exact_with_a_clean_report(case):
    assert all(k.startswith("module.") for k in case["ref"])
    assert torch_import.detect_checkpoint_family(case["ref"]) == case["family"]
    port = _fresh(case)
    flat = PORT_CONVERTER[case["family"]](case["ref"], **case["kwargs"])
    report = torch_import.apply_to_model(flat, port)
    assert report == {"matched": len(case["state"]), "missing": [], "unused": [], "shape_mismatch": []}
    for k, v in port.state_dict().items():
        assert torch.equal(v, case["state"][k]), k


def test_import_matches_jax(case):
    family = case["family"]
    sd = {k: v for k, v in case["ref"].items() if k != f"module.{case['drop']}"}
    assert len(sd) == len(case["ref"]) - 1
    sd[f"module.{case['stray']}"] = torch.ones(3)

    # both start from one other tree, so the tensors left missing agree too
    other = random_params(case["init"], seed=2)
    port = case["make_port"]().eval()
    load_from_jax(port, other)
    report = torch_import.apply_to_model(PORT_CONVERTER[family](sd, **case["kwargs"]), port)
    new_params, jreport = jax_import.apply_to_params(
        JAX_CONVERTER[family]({k: v.numpy() for k, v in sd.items()}, **case["kwargs"]), other)
    want = params_from_jax(jax.tree.map(np.asarray, new_params))
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    assert report["matched"] == jreport["matched"] == len(got) - len(report["missing"])
    assert sorted(report["missing"]) == sorted(_port_key(p) for p in jreport["missing"])
    # one tensor; a packed bias's q / k / v; a packed weight's, whose biases are read with it
    assert len(report["missing"]) in (1, 3, 6)
    assert sorted(report["unused"]) == sorted(_port_key(p) for p in jreport["unused"])
    assert report["shape_mismatch"] == jreport["shape_mismatch"] == []
    # what was dropped keeps the model's own values
    for k in report["missing"]:
        assert not torch.equal(got[k], case["state"][k]), k


def test_detection_and_loading_from_a_file(case, tmp_path):
    assert torch_import.detect_checkpoint_family(case["ref"]) == jax_import.detect_checkpoint_family(
        {k: None for k in case["ref"]})
    path = tmp_path / "model_final.pth"
    torch.save({"model": case["ref"], "iteration": 1}, path)
    port = _fresh(case)
    report = torch_import.load_reference_weights(str(path), port, **case["kwargs"])
    assert report["matched"] == len(case["state"]) and not report["missing"]
    for k, v in port.state_dict().items():
        assert torch.equal(v, case["state"][k]), k


def test_shape_mismatch_raises_and_writes_nothing():
    make_port = CASES["idol_r50"][0]()[2]
    port = make_port()
    init_weights(port, seed=0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    ref = torch_import.to_reference_names(before, "idol")
    ref["detr.detr.query_embed.weight"] = torch.zeros(3, 4)
    ref = {k: v + 1 for k, v in ref.items()}
    with pytest.raises(ValueError, match="query_embed"):
        torch_import.apply_to_model(torch_import.convert_idol_checkpoint(ref, 2, 1), port)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_backbone_only_checkpoint_matches_jax():
    """An ImageNet-style backbone checkpoint (detectron2 names, no prefix) into
    IDOL-R50: the backbone matches, the rest is reported missing, as in JAX."""
    make_port = CASES["idol_r50"][0]()[2]
    port = make_port()
    init_weights(port, seed=0)
    ref = torch_import.to_reference_names(port.state_dict(), "idol")
    sd = {k[len(BB):]: v for k, v in ref.items() if k.startswith(BB)}
    assert torch_import.detect_checkpoint_family(sd) == jax_import.detect_checkpoint_family(sd) == "d2_backbone"
    flat = torch_import.convert_d2_backbone_checkpoint(sd)
    jflat = jax_import.convert_d2_backbone_checkpoint({k: v.numpy() for k, v in sd.items()})
    assert sorted(flat) == sorted(_port_key(p) for p in jflat)
    fresh = make_port()
    init_weights(fresh, seed=3)
    report = torch_import.apply_to_model(flat, fresh)
    assert report["matched"] == len(sd) == sum(k.startswith("backbone.") for k in port.state_dict())
    assert all(not k.startswith("backbone.") for k in report["missing"]) and not report["unused"]


def test_unknown_port_key_and_pkl_raise(tmp_path):
    with pytest.raises(KeyError, match="stray"):
        torch_import.to_reference_names({"stray.weight": torch.zeros(1)}, "idol")
    with pytest.raises(NotImplementedError, match="item 11"):
        torch_import.load_torch_state_dict(str(tmp_path / "model.pkl"))
    assert torch_import.detect_checkpoint_family({"module.stem.conv1.weight": None}) == "d2_backbone"
