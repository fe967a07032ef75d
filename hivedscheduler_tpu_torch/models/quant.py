"""Weight-only int8 quantization for serving.

Counterpart of ``hivedscheduler_tpu/models/quant.py``. Post-training,
symmetric, per output channel: q = round(w / s), s = max|w| / 127 reduced
over the input (contraction) axes, with round half to even as in JAX. Norm
weights and the MoE router stay float; each expert of a stacked MoE leaf
[L, E, in, out] gets its own scales. Each quantized leaf becomes
``{"qi8": int8, "scale": f32}`` with the scale kept at the weight's rank
(size 1 on the reduced axes); the decode path's weight loads
(``transformer.load_weight``) dequantize either tree. :func:`sharding_specs`
lays a quantized tree over the serving mesh
(``decode.serving_shardings(..., quantized=True)``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from hivedscheduler_tpu_torch.models.transformer import TransformerConfig

# leaf name -> input (contraction) axes to reduce the scale over, for the
# per-layer-stacked [L, ...] layout of init_params
_LAYER_CONTRACT_AXES = {
    "wq": (1,),        # [L, d, h, hd] contracts d
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),      # [L, h, hd, d] contracts h, hd
    "w_gate": (1,),    # dense [L, d, f] contracts d; MoE [L, E, d, f] -> (2,)
    "w_up": (1,),
    "w_down": (1,),    # dense [L, f, d] contracts f; MoE [L, E, f, d] -> (2,)
}


def _contract_axes(name: str, moe: bool) -> Tuple[int, ...]:
    """Input (contraction) axes of a layer leaf."""
    if moe and name in ("w_gate", "w_up", "w_down"):
        return (2,)  # [L, E, in, out]: per-expert input
    return _LAYER_CONTRACT_AXES[name]


def _quantize_leaf(w: torch.Tensor, axes: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    scale = torch.amax(w.abs(), dim=axes, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-8).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"qi8": q, "scale": scale}


def quantize_params(params: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """Quantize the matmul weights of a base param tree: embed per row (the
    gather then scales one row per token), lm_head per output column,
    layer projections per output channel. Norms and any other leaf pass
    through. ``lora_*`` leaves are refused: fold adapters in first."""
    if any(k.startswith("lora_") for k in params["layers"]):
        raise ValueError(
            "quantize after merge_lora: adapters must be folded into the base"
        )
    moe = cfg.n_experts > 0
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "embed":
            out[name] = _quantize_leaf(leaf, (1,))
        elif name == "lm_head":
            out[name] = _quantize_leaf(leaf, (0,))
        elif name == "layers":
            out[name] = {
                lname: (_quantize_leaf(w, _contract_axes(lname, moe))
                        if lname in _LAYER_CONTRACT_AXES else w)
                for lname, w in leaf.items()
            }
        else:
            out[name] = leaf
    return out


def sharding_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The specs of a quantized tree, the JAX package's
    ``quant.sharding_specs``: ``qi8`` takes the base weight's spec
    (``transformer.sharding_specs``); the keepdims scale drops the sharding
    of every reduced (size-1) axis, so a scale over a tp-sharded
    contraction (``wo``'s heads, ``w_down``'s hidden dim) is whole on every
    rank and a per-output-channel one is cut with its channels."""
    from hivedscheduler_tpu_torch.models import transformer as tm

    base = tm.sharding_specs(cfg)
    moe = cfg.n_experts > 0

    def qspec(spec: tuple, axes: Tuple[int, ...]) -> Dict[str, Any]:
        return {"qi8": spec,
                "scale": tuple(None if i in axes else s for i, s in enumerate(spec))}

    layers: Dict[str, Any] = {}
    for name, spec in base["layers"].items():
        if name in _LAYER_CONTRACT_AXES:
            layers[name] = qspec(spec, _contract_axes(name, moe))
        else:
            layers[name] = spec
    return {
        "embed": qspec(base["embed"], (1,)),
        "layers": layers,
        "final_norm": base["final_norm"],
        "lm_head": qspec(base["lm_head"], (0,)),
    }
