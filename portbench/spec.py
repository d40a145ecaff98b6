"""A configuration file's sizes as the reference and the counts read them.

The file holds the model's published keys as run (``hidden_size``,
``num_hidden_layers``, ...) and a ``run`` object with what the published
keys do not say about the port's model (the family, qk-norm, the hybrid's
period and window).  ``program_config`` builds the program's own
``ModelConfig`` from the file's ``program`` entry and refuses one whose
sizes differ from the file's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Spec:
    family: str                 # "dense" | "hybrid"
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    rope_theta: float
    qk_norm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 0
    ssm_chunk: int = 0
    conv_k: int = 4
    attn_every: int = 0
    window: int = 0

    @property
    def vocab_pad(self) -> int:
        return (self.vocab + 127) // 128 * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def sites(self) -> int:
        """Applications of the hybrid's shared block."""
        return self.layers // self.attn_every if self.attn_every else 0


def spec_of(config: dict) -> Spec:
    run = config["run"]
    d, heads = config["hidden_size"], config["num_attention_heads"]
    hybrid = run["family"] == "hybrid"
    return Spec(
        family=run["family"],
        layers=config["num_hidden_layers"],
        d=d,
        heads=heads,
        kv_heads=config["num_key_value_heads"],
        head_dim=run.get("attn_head_dim", config.get("head_dim",
                                                      d // heads)),
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        eps=config["rms_norm_eps"],
        rope_theta=float(config["rope_theta"]),
        qk_norm=run.get("qk_norm", False),
        ssm_state=config["mamba_d_state"] if hybrid else 0,
        ssm_head_dim=config["mamba_headdim"] if hybrid else 0,
        ssm_expand=config["mamba_expand"] if hybrid else 0,
        ssm_chunk=config["chunk_size"] if hybrid else 0,
        conv_k=config.get("mamba_d_conv", 4),
        attn_every=run.get("attn_every", 0),
        window=run.get("attn_window", 0),
    )


def program_config(config: dict):
    """The program's ``ModelConfig`` for ``config``: its registered
    architecture with the file's ``program.overrides``, checked against
    the file's sizes."""
    from repro_torch.configs import get_config
    prog = config["program"]
    cfg = get_config(prog["arch"])
    if prog.get("overrides"):
        cfg = cfg.scaled(**prog["overrides"])
    spec = spec_of(config)
    run = config["run"]
    want = {
        "num_layers": spec.layers, "d_model": spec.d,
        "num_heads": spec.heads, "num_kv_heads": spec.kv_heads,
        "resolved_head_dim": spec.head_dim, "d_ff": spec.d_ff,
        "vocab_size": spec.vocab, "norm_eps": spec.eps,
        "rope_theta": spec.rope_theta, "qk_norm": spec.qk_norm,
        "ssm_state": spec.ssm_state, "attn_every": spec.attn_every,
        "attn_window": spec.window,
        "param_dtype": run["param_dtype"],
        "compute_dtype": run["compute_dtype"], "remat": run["remat"],
    }
    if spec.family == "hybrid":
        want.update(ssm_head_dim=spec.ssm_head_dim,
                    ssm_expand=spec.ssm_expand, ssm_chunk=spec.ssm_chunk)
    got = {k: getattr(cfg, k) for k in want}
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise ValueError(f"the program's {prog['arch']} differs from "
                         f"{config['name']}'s file (program, file): {wrong}")
    return cfg
