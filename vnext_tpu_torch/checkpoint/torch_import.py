"""Reference PyTorch checkpoints (``.pth`` / ``.pt``) into the port.

Counterpart of ``vnext_tpu.checkpoint.torch_import`` for the families the port
serves: IDOL and SeqFormer (ResNet or Swin backbone) and MinVIS/Mask2Former.
The port's layouts are torch's, so a reference name maps straight to a port
key: Linear, Conv, LayerNorm and GroupNorm tensors keep their layout, and only
``nn.MultiheadAttention``'s packed ``in_proj`` splits into the q / k / v
projections. Each converter walks the reference names as the JAX package's
does and returns {port key: tensor}; :func:`apply_to_model` writes them into a
model and returns the JAX importer's report (matched / missing / unused /
shape mismatches). A shape mismatch raises; missing keys are logged.

:func:`to_reference_names` goes the other way: a port state dict under the
reference's names, as the reference code would save it.

The JAX package keeps its norm eps (flax LayerNorm / GroupNorm 1e-6, frozen BN
1e-5) and so does the port: weights trained with the reference Swin's
LayerNorm eps 1e-5 run here at 1e-6 (ROADMAP Queue 3).
"""

from __future__ import annotations

import inspect
import logging
import re
from typing import Dict

import torch
from torch import nn

logger = logging.getLogger("vnext_tpu_torch")

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pth`` / ``.pt`` checkpoint's state dict, CPU tensors. A ``model`` or
    ``state_dict`` entry is unwrapped, as the JAX package's loader does."""
    if path.endswith(".pkl"):
        raise NotImplementedError("detectron2 .pkl checkpoints are not ported yet: ROADMAP Queue 1, item 11")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: torch.as_tensor(v) for k, v in blob.items()}


def _strip_module(sd: StateDict) -> StateDict:
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def _pair(src: str, dst: str, sd: StateDict, out: StateDict) -> None:
    """A Linear, Conv or norm: ``weight`` and ``bias``, as they are."""
    for leaf in ("weight", "bias"):
        v = sd.get(f"{src}.{leaf}")
        if v is not None:
            out[f"{dst}.{leaf}"] = v


def _frozen_bn(src: str, dst: str, sd: StateDict, out: StateDict) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        v = sd.get(f"{src}.{leaf}")
        if v is not None:
            out[f"{dst}.{leaf}"] = v


def _mlp(src: str, dst: str, sd: StateDict, out: StateDict, num_layers: int = 3) -> None:
    for j in range(num_layers):
        _pair(f"{src}.layers.{j}", f"{dst}.layers_{j}", sd, out)


def _packed_mha(src: str, dst: str, sd: StateDict, out: StateDict) -> None:
    """torch ``nn.MultiheadAttention`` (packed ``in_proj``) -> q / k / v / out projections."""
    w, b = sd.get(f"{src}.in_proj_weight"), sd.get(f"{src}.in_proj_bias")
    if w is not None:
        c = w.shape[0] // 3
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{dst}.{name}.weight"] = w[j * c:(j + 1) * c]
            if b is not None:
                out[f"{dst}.{name}.bias"] = b[j * c:(j + 1) * c]
    _pair(f"{src}.out_proj", f"{dst}.out_proj", sd, out)


def _convert_swin_backbone(bb: str, sd: StateDict, out: StateDict) -> None:
    """Detection-Swin names (idol/backbone/swin.py) -> the port's ``SwinTransformer``."""
    _pair(f"{bb}.patch_embed.proj", "backbone.patch_embed", sd, out)
    _pair(f"{bb}.patch_embed.norm", "backbone.patch_norm", sd, out)
    for s in range(4):
        b = 0
        while f"{bb}.layers.{s}.blocks.{b}.norm1.weight" in sd:
            pre, tgt = f"{bb}.layers.{s}.blocks.{b}", f"backbone.layers_{s}_blocks_{b}"
            for name in ("norm1", "norm2", "attn.qkv", "attn.proj"):
                _pair(f"{pre}.{name}", f"{tgt}.{name}", sd, out)
            tbl = sd.get(f"{pre}.attn.relative_position_bias_table")
            if tbl is not None:
                out[f"{tgt}.attn.relative_position_bias_table"] = tbl
            _pair(f"{pre}.mlp.fc1", f"{tgt}.mlp_fc1", sd, out)
            _pair(f"{pre}.mlp.fc2", f"{tgt}.mlp_fc2", sd, out)
            b += 1
        _pair(f"{bb}.layers.{s}.downsample.reduction", f"backbone.downsample_{s}.reduction", sd, out)
        _pair(f"{bb}.layers.{s}.downsample.norm", f"backbone.downsample_{s}.norm", sd, out)
        _pair(f"{bb}.norm{s}", f"backbone.out_norm{s}", sd, out)


def convert_d2_resnet(sd: StateDict, src_prefix: str = "", dst_prefix: str = "backbone",
                      out: StateDict = None) -> StateDict:
    """A detectron2 ResNet (``stem.conv1`` / ``res{2..5}.{b}.conv{j}`` with
    FrozenBatchNorm2d ``norm``s, shortcut projections) -> the port's ``ResNet``."""
    out = {} if out is None else out
    _pair(f"{src_prefix}stem.conv1", f"{dst_prefix}.conv1", sd, out)
    _frozen_bn(f"{src_prefix}stem.conv1.norm", f"{dst_prefix}.bn1", sd, out)
    for s in (2, 3, 4, 5):
        b = 0
        while f"{src_prefix}res{s}.{b}.conv1.weight" in sd:
            pre, tgt = f"{src_prefix}res{s}.{b}", f"{dst_prefix}.layer{s - 1}_{b}"
            for j in (1, 2, 3):
                if f"{pre}.conv{j}.weight" in sd:
                    _pair(f"{pre}.conv{j}", f"{tgt}.conv{j}", sd, out)
                    _frozen_bn(f"{pre}.conv{j}.norm", f"{tgt}.bn{j}", sd, out)
            if f"{pre}.shortcut.weight" in sd:
                _pair(f"{pre}.shortcut", f"{tgt}.downsample_conv", sd, out)
                _frozen_bn(f"{pre}.shortcut.norm", f"{tgt}.downsample_bn", sd, out)
            b += 1
    return out


def _convert_detr_backbone(sd: StateDict, out: StateDict, num_feature_levels: int) -> None:
    """IDOL's and SeqFormer's backbone (ResNet or Swin) and input projections."""
    bb = "detr.detr.backbone.0.backbone"
    if f"{bb}.patch_embed.proj.weight" in sd:
        _convert_swin_backbone(bb, sd, out)
    else:
        convert_d2_resnet(sd, src_prefix=bb + ".", out=out)
    for i in range(num_feature_levels):
        _pair(f"detr.detr.input_proj.{i}.0", f"input_proj_{i}.conv", sd, out)
        _pair(f"detr.detr.input_proj.{i}.1", f"input_proj_{i}.norm", sd, out)


def _convert_encoder(pre: str, tgt: str, sd: StateDict, out: StateDict) -> None:
    for mod in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _pair(f"{pre}.self_attn.{mod}", f"{tgt}.self_attn.{mod}", sd, out)
    for name in ("norm1", "norm2", "linear1", "linear2"):
        _pair(f"{pre}.{name}", f"{tgt}.{name}", sd, out)


def convert_idol_checkpoint(sd: StateDict, dec_layers: int = 6, enc_layers: int = 6,
                            num_feature_levels: int = 4) -> StateDict:
    """An IDOL state dict (ResNet or Swin under ``detr.detr.backbone.0.backbone``) -> port keys."""
    sd = _strip_module(sd)
    out: StateDict = {}
    _convert_detr_backbone(sd, out, num_feature_levels)
    t = "detr.detr.transformer"
    if f"{t}.level_embed" in sd:
        out["transformer.level_embed"] = sd[f"{t}.level_embed"]
    _pair(f"{t}.reference_points", "transformer.reference_points", sd, out)
    for i in range(enc_layers):
        _convert_encoder(f"{t}.encoder.layers.{i}", f"transformer.encoder_{i}", sd, out)
    for i in range(dec_layers):
        pre, tgt = f"{t}.decoder.layers.{i}", f"transformer.decoder_{i}"
        for mod in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            _pair(f"{pre}.cross_attn.{mod}", f"{tgt}.cross_attn.{mod}", sd, out)
        _packed_mha(f"{pre}.self_attn", f"{tgt}.self_attn", sd, out)
        for name in ("norm1", "norm2", "norm3", "linear1", "linear2"):
            _pair(f"{pre}.{name}", f"{tgt}.{name}", sd, out)
    for i in range(dec_layers):
        _pair(f"detr.detr.class_embed.{i}", f"class_embed_{i}", sd, out)
        _mlp(f"detr.detr.bbox_embed.{i}", f"transformer.bbox_embed_{i}", sd, out)
    if "detr.detr.query_embed.weight" in sd:
        out["query_embed"] = sd["detr.detr.query_embed.weight"]
    _mlp("detr.controller", "controller", sd, out)
    _mlp("detr.reid_embed_head", "reid_embed", sd, out)
    for lay in ("lay1", "lay2", "lay3", "lay4", "dcn"):
        _pair(f"detr.mask_head.{lay}", f"mask_head.{lay}", sd, out)
    return out


def convert_seqformer_transformer(sd: StateDict, enc_layers: int = 6, dec_layers: int = 6,
                                  prefix: str = "transformer") -> StateDict:
    """A reference SeqFormer ``DeformableTransformer`` state dict -> port keys
    under ``prefix``: IDOL's encoder, and a decoder layer with the box-query
    branch (``self_attn_box``, ``norm{1,2,3}_box``, ``linear{1,2}_box``), the
    dual-output cross attention's ``output_proj_box`` and
    ``time_attention_weights``; ``decoder.bbox_embed.{i}``."""
    out: StateDict = {}
    if "level_embed" in sd:
        out[f"{prefix}.level_embed"] = sd["level_embed"]
    _pair("reference_points", f"{prefix}.reference_points", sd, out)
    for i in range(enc_layers):
        _convert_encoder(f"encoder.layers.{i}", f"{prefix}.encoder_{i}", sd, out)
    for i in range(dec_layers):
        pre, tgt = f"decoder.layers.{i}", f"{prefix}.decoder_{i}"
        for mod in ("sampling_offsets", "attention_weights", "value_proj", "output_proj", "output_proj_box"):
            _pair(f"{pre}.cross_attn.{mod}", f"{tgt}.cross_attn.{mod}", sd, out)
        _packed_mha(f"{pre}.self_attn", f"{tgt}.self_attn", sd, out)
        _packed_mha(f"{pre}.self_attn_box", f"{tgt}.self_attn_box", sd, out)
        for name in ("norm1", "norm2", "norm3", "norm1_box", "norm2_box", "norm3_box",
                     "linear1", "linear2", "linear1_box", "linear2_box", "time_attention_weights"):
            _pair(f"{pre}.{name}", f"{tgt}.{name}", sd, out)
        _mlp(f"decoder.bbox_embed.{i}", f"{prefix}.bbox_embed_{i}", sd, out)
    return out


def convert_seqformer_checkpoint(sd: StateDict, dec_layers: int = 6, enc_layers: int = 6,
                                 num_feature_levels: int = 4) -> StateDict:
    """A SeqFormer state dict (IDOL's skeleton without the ReID head, the
    dual-query transformer) -> port keys."""
    sd = _strip_module(sd)
    out: StateDict = {}
    _convert_detr_backbone(sd, out, num_feature_levels)
    t = "detr.detr.transformer."
    sub = {k[len(t):]: v for k, v in sd.items() if k.startswith(t)}
    out.update(convert_seqformer_transformer(sub, enc_layers=enc_layers, dec_layers=dec_layers))
    for i in range(dec_layers):
        # the box-refinement MLPs also appear as detr.detr.bbox_embed (the same modules)
        if f"transformer.bbox_embed_{i}.layers_0.weight" not in out:
            _mlp(f"detr.detr.bbox_embed.{i}", f"transformer.bbox_embed_{i}", sd, out)
        _pair(f"detr.detr.class_embed.{i}", f"class_embed_{i}", sd, out)
    if "detr.detr.query_embed.weight" in sd:
        out["query_embed"] = sd["detr.detr.query_embed.weight"]
    _mlp("detr.controller", "controller", sd, out)
    for lay in ("lay1", "lay2", "lay3", "lay4", "dcn"):
        _pair(f"detr.mask_head.{lay}", f"mask_head.{lay}", sd, out)
    return out


def convert_mask2former_decoder(sd: StateDict, dec_layers: int = 9,
                                prefix: str = "transformer_decoder") -> StateDict:
    """A reference ``MultiScaleMaskedTransformerDecoder`` state dict -> port keys under ``prefix``."""
    out: StateDict = {}
    for name, tgt in (("query_feat.weight", "query_feat"), ("query_embed.weight", "query_embed"),
                      ("level_embed.weight", "dec_level_embed")):
        if name in sd:
            out[f"{prefix}.{tgt}"] = sd[name]
    _pair("decoder_norm", f"{prefix}.decoder_norm", sd, out)
    _pair("class_embed", f"{prefix}.class_embed", sd, out)
    _mlp("mask_embed", f"{prefix}.mask_embed", sd, out)
    for i in range(dec_layers):
        cross, self_, ffn = (f"transformer_cross_attention_layers.{i}", f"transformer_self_attention_layers.{i}",
                             f"transformer_ffn_layers.{i}")
        _packed_mha(f"{cross}.multihead_attn", f"{prefix}.cross_{i}", sd, out)
        _pair(f"{cross}.norm", f"{prefix}.cross_norm_{i}", sd, out)
        _packed_mha(f"{self_}.self_attn", f"{prefix}.self_{i}", sd, out)
        _pair(f"{self_}.norm", f"{prefix}.self_norm_{i}", sd, out)
        _pair(f"{ffn}.linear1", f"{prefix}.ffn1_{i}", sd, out)
        _pair(f"{ffn}.linear2", f"{prefix}.ffn2_{i}", sd, out)
        _pair(f"{ffn}.norm", f"{prefix}.ffn_norm_{i}", sd, out)
    return out


def convert_minvis_checkpoint(sd: StateDict, enc_layers: int = 6, dec_layers: int = 9) -> StateDict:
    """A MinVIS / Mask2Former release (``backbone.`` d2 ResNet,
    ``sem_seg_head.pixel_decoder.``, ``sem_seg_head.predictor.``) -> port keys."""
    sd = _strip_module(sd)
    out: StateDict = {}
    convert_d2_resnet(sd, src_prefix="backbone.", out=out)
    pd = "sem_seg_head.pixel_decoder"
    if f"{pd}.transformer.level_embed" in sd:
        out["pixel_decoder.level_embed"] = sd[f"{pd}.transformer.level_embed"]
    for i in range(3):   # the reference's order: res5 first
        _pair(f"{pd}.input_proj.{i}.0", f"pixel_decoder.input_proj_{i}", sd, out)
        _pair(f"{pd}.input_proj.{i}.1", f"pixel_decoder.input_norm_{i}", sd, out)
    for i in range(enc_layers):
        _convert_encoder(f"{pd}.transformer.encoder.layers.{i}", f"pixel_decoder.encoder_{i}", sd, out)
    _pair(f"{pd}.adapter_1", "pixel_decoder.adapter_res2", sd, out)
    _pair(f"{pd}.adapter_1.norm", "pixel_decoder.adapter_norm", sd, out)
    _pair(f"{pd}.layer_1", "pixel_decoder.output_conv", sd, out)
    _pair(f"{pd}.layer_1.norm", "pixel_decoder.output_norm", sd, out)
    _pair(f"{pd}.mask_features", "pixel_decoder.mask_features", sd, out)
    p = "sem_seg_head.predictor."
    out.update(convert_mask2former_decoder({k[len(p):]: v for k, v in sd.items() if k.startswith(p)},
                                           dec_layers=dec_layers))
    return out


def convert_d2_backbone_checkpoint(sd: StateDict) -> StateDict:
    """A backbone-only detectron2-name checkpoint (an ImageNet init) -> ``backbone.*``."""
    return convert_d2_resnet(_strip_module(sd))


def detect_checkpoint_family(sd: StateDict) -> str:
    """'minvis' (sem_seg_head.*), 'seqformer' (cross_attn.output_proj_box),
    'd2_backbone' (stem.conv1.weight) or 'idol', as the JAX package sniffs it."""
    keys = set(_strip_module(sd))
    if any(k.startswith("sem_seg_head.") for k in keys):
        return "minvis"
    if any(".cross_attn.output_proj_box." in k for k in keys):
        return "seqformer"
    if "stem.conv1.weight" in keys:
        return "d2_backbone"
    return "idol"


CONVERTERS = {"minvis": convert_minvis_checkpoint, "seqformer": convert_seqformer_checkpoint,
              "idol": convert_idol_checkpoint, "d2_backbone": convert_d2_backbone_checkpoint}


def apply_to_model(flat: StateDict, model: nn.Module) -> Dict:
    """Write converted tensors into ``model`` (cast to each parameter's dtype
    and device) and return the report: ``matched`` (a count), ``missing`` (the
    model's keys the checkpoint lacks, left as they were and logged),
    ``unused`` (converted keys the model lacks) and ``shape_mismatch``. A shape
    mismatch raises before anything is written."""
    own = model.state_dict()
    matched, missing, shape_mismatch = [], [], []
    for key, leaf in own.items():
        if key not in flat:
            missing.append(key)
        elif tuple(flat[key].shape) != tuple(leaf.shape):
            shape_mismatch.append((key, tuple(flat[key].shape), tuple(leaf.shape)))
        else:
            matched.append(key)
    if shape_mismatch:
        raise ValueError("reference import: shapes differ (key, checkpoint, model): "
                         + ", ".join(map(str, shape_mismatch)))
    with torch.no_grad():
        for key in matched:
            own[key].copy_(torch.as_tensor(flat[key]))
    if missing:
        logger.warning("reference import: %d of the model's tensors are not in the checkpoint: %s",
                       len(missing), missing[:5])
    return {"matched": len(matched), "missing": missing, "unused": [k for k in flat if k not in own],
            "shape_mismatch": shape_mismatch}


def load_reference_weights(path: str, model: nn.Module, **kwargs) -> Dict:
    """Load a reference ``.pth`` into ``model``, its family detected; returns the
    report. ``kwargs`` (``dec_layers``, ``enc_layers``, ``num_feature_levels``)
    go to the converter that takes them. Raises when nothing matched."""
    sd = load_torch_state_dict(path)
    family = detect_checkpoint_family(sd)
    converter = CONVERTERS[family]
    accepted = set(inspect.signature(converter).parameters)
    dropped = sorted(set(kwargs) - accepted)
    if dropped:
        logger.warning("reference import: the %s converter takes none of %s", family, dropped)
    report = apply_to_model(converter(sd, **{k: v for k, v in kwargs.items() if k in accepted}), model)
    if report["matched"] == 0:
        raise ValueError(f"reference checkpoint {path} ({family} format) matched no tensor of the model")
    logger.info("reference import: %s-format checkpoint %s, %d tensors matched", family, path, report["matched"])
    return report


# ---------------------------------------------------------------- the other way
_DETR_BB = "detr.detr.backbone.0.backbone."
_BACKBONE_RULES = (
    (r"backbone\.conv1\.weight", "{bb}stem.conv1.weight"),
    (r"backbone\.bn1\.(\w+)", "{bb}stem.conv1.norm.\\1"),
    (r"backbone\.layer(\d)_(\d+)\.conv(\d)\.weight", "{bb}res{s+1}.\\2.conv\\3.weight"),
    (r"backbone\.layer(\d)_(\d+)\.bn(\d)\.(\w+)", "{bb}res{s+1}.\\2.conv\\3.norm.\\4"),
    (r"backbone\.layer(\d)_(\d+)\.downsample_conv\.weight", "{bb}res{s+1}.\\2.shortcut.weight"),
    (r"backbone\.layer(\d)_(\d+)\.downsample_bn\.(\w+)", "{bb}res{s+1}.\\2.shortcut.norm.\\3"),
    (r"backbone\.patch_embed\.(\w+)", "{bb}patch_embed.proj.\\1"),
    (r"backbone\.patch_norm\.(\w+)", "{bb}patch_embed.norm.\\1"),
    (r"backbone\.layers_(\d)_blocks_(\d+)\.mlp_fc(\d)\.(\w+)", "{bb}layers.\\1.blocks.\\2.mlp.fc\\3.\\4"),
    (r"backbone\.layers_(\d)_blocks_(\d+)\.(.+)", "{bb}layers.\\1.blocks.\\2.\\3"),
    (r"backbone\.downsample_(\d)\.(.+)", "{bb}layers.\\1.downsample.\\2"),
    (r"backbone\.out_norm(\d)\.(\w+)", "{bb}norm\\1.\\2"),
)
_DETR_RULES = (
    (r"input_proj_(\d)\.conv\.(\w+)", "detr.detr.input_proj.\\1.0.\\2"),
    (r"input_proj_(\d)\.norm\.(\w+)", "detr.detr.input_proj.\\1.1.\\2"),
    (r"transformer\.(level_embed|reference_points\.\w+)", "detr.detr.transformer.\\1"),
    (r"transformer\.encoder_(\d+)\.(.+)", "detr.detr.transformer.encoder.layers.\\1.\\2"),
    (r"transformer\.decoder_(\d+)\.(.+)", "detr.detr.transformer.decoder.layers.\\1.\\2"),
    (r"class_embed_(\d+)\.(\w+)", "detr.detr.class_embed.\\1.\\2"),
    (r"query_embed", "detr.detr.query_embed.weight"),
    (r"controller\.layers_(\d)\.(\w+)", "detr.controller.layers.\\1.\\2"),
    (r"reid_embed\.layers_(\d)\.(\w+)", "detr.reid_embed_head.layers.\\1.\\2"),
    (r"mask_head\.(.+)", "detr.mask_head.\\1"),
)
_BBOX_RULE = {"idol": (r"transformer\.bbox_embed_(\d+)\.layers_(\d)\.(\w+)", "detr.detr.bbox_embed.\\1.layers.\\2.\\3"),
              "seqformer": (r"transformer\.bbox_embed_(\d+)\.layers_(\d)\.(\w+)",
                            "detr.detr.transformer.decoder.bbox_embed.\\1.layers.\\2.\\3")}
_PD, _PRED = "sem_seg_head.pixel_decoder.", "sem_seg_head.predictor."
_MINVIS_RULES = (
    (r"pixel_decoder\.level_embed", _PD + "transformer.level_embed"),
    (r"pixel_decoder\.input_proj_(\d)\.(\w+)", _PD + "input_proj.\\1.0.\\2"),
    (r"pixel_decoder\.input_norm_(\d)\.(\w+)", _PD + "input_proj.\\1.1.\\2"),
    (r"pixel_decoder\.encoder_(\d+)\.(.+)", _PD + "transformer.encoder.layers.\\1.\\2"),
    (r"pixel_decoder\.adapter_res2\.(\w+)", _PD + "adapter_1.\\1"),
    (r"pixel_decoder\.adapter_norm\.(\w+)", _PD + "adapter_1.norm.\\1"),
    (r"pixel_decoder\.output_conv\.(\w+)", _PD + "layer_1.\\1"),
    (r"pixel_decoder\.output_norm\.(\w+)", _PD + "layer_1.norm.\\1"),
    (r"pixel_decoder\.mask_features\.(\w+)", _PD + "mask_features.\\1"),
    (r"transformer_decoder\.(query_feat|query_embed)", _PRED + "\\1.weight"),
    (r"transformer_decoder\.dec_level_embed", _PRED + "level_embed.weight"),
    (r"transformer_decoder\.(decoder_norm|class_embed)\.(\w+)", _PRED + "\\1.\\2"),
    (r"transformer_decoder\.mask_embed\.layers_(\d)\.(\w+)", _PRED + "mask_embed.layers.\\1.\\2"),
    (r"transformer_decoder\.cross_(\d+)\.(.+)", _PRED + "transformer_cross_attention_layers.\\1.multihead_attn.\\2"),
    (r"transformer_decoder\.cross_norm_(\d+)\.(\w+)", _PRED + "transformer_cross_attention_layers.\\1.norm.\\2"),
    (r"transformer_decoder\.self_(\d+)\.(.+)", _PRED + "transformer_self_attention_layers.\\1.self_attn.\\2"),
    (r"transformer_decoder\.self_norm_(\d+)\.(\w+)", _PRED + "transformer_self_attention_layers.\\1.norm.\\2"),
    (r"transformer_decoder\.ffn(\d)_(\d+)\.(\w+)", _PRED + "transformer_ffn_layers.\\2.linear\\1.\\3"),
    (r"transformer_decoder\.ffn_norm_(\d+)\.(\w+)", _PRED + "transformer_ffn_layers.\\1.norm.\\2"),
)
_PACKED = re.compile(r"(.+)\.(q|k|v)_proj\.(weight|bias)$")


def _rename(key: str, rules, bb: str) -> str:
    for pattern, template in rules:
        m = re.fullmatch(pattern, key)
        if m:
            name = m.expand(template.replace("{bb}", bb))
            if "{s+1}" in name:   # ResNet stage s (layer{s}_) is the reference's res{s+1}
                name = name.replace("{s+1}", str(int(m.group(1)) + 1))
            return name
    raise KeyError(f"no reference name for the port key {key!r}")


def to_reference_names(state: StateDict, family: str) -> StateDict:
    """A port state dict (``model.state_dict()``) under the reference's names
    for ``family`` ("idol", "seqformer" or "minvis"), q / k / v projections
    packed into ``in_proj_weight`` / ``in_proj_bias``: what the converters
    above read back to the same tensors."""
    if family == "minvis":
        rules, bb = _BACKBONE_RULES + _MINVIS_RULES, "backbone."
    else:
        rules, bb = _BACKBONE_RULES + (_BBOX_RULE[family],) + _DETR_RULES, _DETR_BB
    out: StateDict = {}
    packed: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        name = _rename(key, rules, bb)
        m = _PACKED.fullmatch(name)
        if m:
            packed.setdefault(f"{m.group(1)}.in_proj_{m.group(3)}", {})[m.group(2)] = value
        else:
            out[name] = value
    for name, parts in packed.items():
        out[name] = torch.cat([parts["q"], parts["k"], parts["v"]])
    return out
