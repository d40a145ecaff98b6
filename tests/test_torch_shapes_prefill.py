"""The prefill and train cells at the production chunk and window against
the JAX package's, on the CPU: sequences past one window (4096) and many
SSM chunks (256).

The models are ``tests/test_torch_shapes_decode.py``'s: tiny in width,
the configs' own ``ssm_chunk`` 256 and ``attn_window`` 4096, the same
parameters in both packages.  The prefill cells run at S 8448 = 33 chunks
for mamba2-1.3b, zamba2-1.2b (whose window then binds: the last 4352 rows
each keep 4096 keys) and qwen3-0.6b, B 1; hubert-xlarge (bidirectional, on
frame embeddings) at S 4096, B 2.  The logits must agree within 1e-4 of
their max (``MODEL_TOL``).  One train-cell step at S 1024 (4 chunks) for
mamba2 and zamba2 from the same parameters: the loss within 1e-4
relative (``STEP_RTOL``) and the unembedding's gradients, the only ones
the reference gives finite at chunk 256.

The reference's prefill runs un-jitted (its layer and chunk scans
compiled): at positions under 8448 its rotary frequencies, rounded
otherwise there (``tests/test_torch_shapes_decode.py``), move the logits
by under 1e-5 of their max.  The JAX package is imported inside the
tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_to_port
from repro_torch.launch import steps
from repro_torch.optim import adamw
from test_torch_shapes_decode import _model, _within
from test_torch_steps import (MODEL_TOL, OPT, STEP_RTOL, _cell_inputs, _jax,
                              _leaves, _np, _ref_cfg, _ref_shape)

CPU = "cpu"
# (arch, B, S)
PREFILLS = [("mamba2-1.3b", 1, 8448), ("zamba2-1.2b", 1, 8448),
            ("qwen3-0.6b", 1, 8448), ("hubert-xlarge", 2, 4096)]
TRAIN_ARCHS, TRAIN_SHAPE = ["mamba2-1.3b", "zamba2-1.2b"], (2, 1024)
UNEMBED = ("lm_head", "final_norm")


@pytest.mark.parametrize("arch,b,s", PREFILLS)
def test_prefill_cell_at_depth_matches_reference(arch, b, s):
    jax, jnp = _jax()
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_prefill_cell as ref_prefill
    cfg, params, model = _model(arch)
    if cfg.ssm_state:
        assert cfg.ssm_chunk == 256 and s % cfg.ssm_chunk == 0
    if cfg.attn_every:
        assert 0 < cfg.attn_window < s
    shape = ShapeConfig("prefill_deep", "prefill", s, b)
    x, _, _ = _cell_inputs(cfg, s, b, s)
    out = steps.build_prefill_cell(cfg, shape, CPU).fn(model,
                                                       torch.from_numpy(x))
    rcell = ref_prefill(_ref_cfg(cfg), _ref_shape(shape), make_host_mesh())
    ref = rcell.fn(params, jnp.asarray(x))
    assert out.shape == ref.shape == (b, s, out.shape[-1])
    _within(_np(out), ref, MODEL_TOL, f"{arch} prefill B {b} x S {s}")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cell_at_depth_matches_reference(arch):
    """One train-cell step at S 1024.  At chunk 256 the reference's scan
    gradient is NaN (``ssd_chunked`` takes the exponent of the masked
    decays before masking them: ROADMAP Queue 3) in every leaf but the
    unembedding's (``lm_head``, ``final_norm``), so its grad norm and
    update are NaN.  The port is held where the reference is defined: the
    loss within STEP_RTOL and the unembedding's gradients within MODEL_TOL
    of their max (the reference differentiated in those leaves alone, so
    that its NaN elsewhere is not computed); and the port's own gradients,
    grad norm and updated parameters finite."""
    jax, jnp = _jax()
    from repro.runtime.coded_step import weighted_loss_fn
    cfg, params, _ = _model(arch)
    model = params_to_port(cfg, params, CPU, trainable=True)
    b, s = TRAIN_SHAPE
    cell = steps.build_train_cell(cfg, ShapeConfig("train_deep", "train", s,
                                                   b),
                                  adamw.AdamWConfig(**OPT), CPU)
    x, labels, w = _cell_inputs(cfg, 7, b, s)
    inputs = [torch.from_numpy(a) for a in (x, labels, w)]
    loss, grads = cell.grad_step(model, *inputs)
    head = {k: params[k] for k in UNEMBED}
    rest = {k: v for k, v in params.items() if k not in head}
    ref_fn = weighted_loss_fn(_ref_cfg(cfg))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda h, r, *a: ref_fn({**r, **h}, *a)))(
        head, rest, *map(jnp.asarray, (x, labels, w)))
    print(f"{arch} loss: port {float(loss):.7g}, reference "
          f"{float(ref_loss):.7g}")
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=STEP_RTOL)
    assert sorted(grads) == sorted(_leaves(params))
    for name in UNEMBED:
        _within(_np(grads[name]), ref_grads[name], MODEL_TOL, f"grad {name}")
    assert all(torch.isfinite(g).all() for g in grads.values())
    model, opt, metrics = cell.fn(model, adamw.init(cell.opt_cfg, model),
                                  *inputs)
    assert np.isfinite(float(metrics["grad_norm"])) and opt.step == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
