"""A fixture family, added as a file of its own: a pure Mamba2 stack
(mamba2-1.3b as the port runs it: the hybrid's Mamba2 layers with no
shared block and no MLP), read from the published mamba2 config's keys
(``d_model``, ``n_layer``, ``ssm_cfg``, ...)."""
from __future__ import annotations

import dataclasses

from .. import weights
from ..reference import model
from ..reference.model import rms
from . import hybrid


@dataclasses.dataclass(frozen=True)
class SSMSpec(hybrid.HybridSpec):
    """No attention: heads, the MLP's width and the sites 0."""


def spec_of(config: dict) -> SSMSpec:
    ssm = config["ssm_cfg"]
    return SSMSpec(family=config["run"]["family"], layers=config["n_layer"],
                   d=config["d_model"], heads=0, kv_heads=0, head_dim=0,
                   d_ff=config["d_intermediate"], vocab=config["vocab_size"],
                   eps=config["norm_epsilon"], rope_theta=0.0,
                   ssm_state=ssm["d_state"], ssm_head_dim=ssm["headdim"],
                   ssm_expand=ssm["expand"], ssm_chunk=ssm["chunk_size"],
                   conv_k=ssm["d_conv"])


def program_checks(s: SSMSpec, run: dict) -> dict:
    return {"num_layers": s.layers, "d_model": s.d, "num_heads": 0,
            "d_ff": s.d_ff, "vocab_size": s.vocab, "norm_eps": s.eps,
            "ssm_state": s.ssm_state, "ssm_head_dim": s.ssm_head_dim,
            "ssm_expand": s.ssm_expand, "ssm_chunk": s.ssm_chunk,
            "attn_every": 0}


def param_shapes(s: SSMSpec) -> weights.Shapes:
    return weights.decoder_layout(s, hybrid.mamba_shapes(s))


fan_in = hybrid.fan_in


def hidden(spec: SSMSpec, num, P, tokens, remat: bool = False):
    x = P["embed"][tokens]
    for i in range(spec.layers):
        x = model.run_layer(lambda x, i=i: hybrid.mamba_layer(
            spec, num, model.layer_params(P, i), x), x, remat)
    return rms(x, P["final_norm"], spec.eps)


def matmul_params(s: SSMSpec) -> float:
    return s.layers * hybrid.mamba_matrices(s) + s.d * s.vocab_pad


def model_flops(s: SSMSpec, batch: int, seq: int, train: bool) -> float:
    flops = 2.0 * matmul_params(s) * (batch * seq)
    flops += hybrid.ssd_flops(s, batch, seq)
    return 3.0 * flops if train else flops
