"""A configuration's sizes, and its weights made from the seed.

The benchmark makes the weights itself, on the device, in the type they
are served in, and hands the same tensors to the program and to the
reference.  The layout is the one the port's ``models/llama.py`` takes:
stacked layers ``{ln1, ln2, wq, wk, wv, wo, w_gate, w_up, w_down}`` with a
leading layer axis, ``embed`` (also the output head, tied) and ``ln_f``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from bench_port.roofline import ModelShape

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_shape(config: Dict[str, Any]) -> ModelShape:
    """The sizes of a configuration file (Hugging Face ``config.json`` keys)."""
    heads = config["num_attention_heads"]
    return ModelShape(
        d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or config["hidden_size"] // heads,
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
    )


def layer_shapes(s: ModelShape) -> Dict[str, tuple]:
    """{leaf: (shape, fan_in)} of the stacked layer weights."""
    L, D, H, K, Dh, F = s.n_layers, s.d_model, s.n_heads, s.n_kv_heads, s.head_dim, s.d_ff
    return {
        "wq": ((L, D, H, Dh), D),
        "wk": ((L, D, K, Dh), D),
        "wv": ((L, D, K, Dh), D),
        "wo": ((L, H, Dh, D), H * Dh),
        "w_gate": ((L, D, F), D),
        "w_up": ((L, D, F), D),
        "w_down": ((L, F, D), F),
    }


def make_weights(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """Weights drawn from ``seed`` on ``device`` by a generator there:
    normal(0, fan_in^-1/2) matrices and norms at 1 + normal(0, 0.1), drawn
    directly in the served type, one call a leaf."""
    s = model_shape(config)
    dtype = DTYPES[config["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def normal(shape, scale):
        out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return out.mul_(scale)

    def norm(shape):
        return normal(shape, 0.1).add_(1.0)

    layers = {"ln1": norm((s.n_layers, s.d_model)), "ln2": norm((s.n_layers, s.d_model))}
    for key, (shape, fan_in) in layer_shapes(s).items():
        layers[key] = normal(shape, fan_in ** -0.5)
    return {
        "embed": normal((s.vocab, s.d_model), s.d_model ** -0.5),
        "layers": layers,
        "ln_f": norm((s.d_model,)),
    }
