"""Faults planted under the timed path, for the tests and the readings
that show each one makes ``correct`` false: a step that leaves its state
unchanged, half of the batch left out with the mean taken over the rest,
and a served token altered where the program produces it.  Each patches
the program's objects at run time and ``remove`` restores them.  A fault
is planted before the warm-up, or, where ``late``, after it: in the
window only."""
from __future__ import annotations


class Frozen:
    """AdamW returns the parameters and moments as they were."""
    kinds = ("train",)
    late = False

    def plant(self, session) -> None:
        from repro_torch.optim import adamw
        self.module, self.orig = adamw, adamw.apply_updates

        def unchanged(cfg, params, grads, state, *args, **kwargs):
            return params, adamw.OptState(state.step + 1, state.mu,
                                          state.nu), \
                {"grad_norm": adamw.global_norm(grads), "lr": 0.0}
        adamw.apply_updates = unchanged

    def remove(self) -> None:
        self.module.apply_updates = self.orig


class HalfBatch:
    """The second half of the workers' rows left out: their decode
    coefficients zeroed, the first half's doubled (the mean over the
    rest)."""
    kinds = ("train",)
    late = False

    def plant(self, session) -> None:
        trainer = session.trainer
        orig = trainer.step_fn
        self.trainer, self.orig = trainer, orig

        def half(params, opt, toks, labs, a):
            a = a.clone()
            a[a.shape[0] // 2:] = 0
            return orig(params, opt, toks, labs, a * 2)
        trainer.step_fn = half

    def remove(self) -> None:
        self.trainer.step_fn = self.orig


class AlteredToken:
    """Row 0's first-placed token moved to the next id, at every
    ``every``-th position of what the program returns."""
    kinds = ("decode", "prefill")
    late = False
    every = 64

    def plant(self, session) -> None:
        orig = session.cell_fn
        self.session, self.orig = session, orig

        def altered(*args):
            out = orig(*args)
            logits = out[0] if isinstance(out, tuple) else out
            row = logits[0, ::self.every]
            alt = (row.argmax(-1) + 1) % row.shape[-1]
            row.scatter_(-1, alt[:, None], row.max(-1, keepdim=True).values
                         + 1)
            return out
        session.cell_fn = altered

    def remove(self) -> None:
        self.session.cell_fn = self.orig


class FrozenLate(Frozen):
    """A state left unchanged by the window's steps only: the set-up's
    steps are sound."""
    late = True


FAULTS = {"frozen": Frozen, "frozen_late": FrozenLate,
          "half_batch": HalfBatch, "altered_token": AlteredToken}


def planted(names, kind: str) -> list:
    faults = [FAULTS[n]() for n in names]
    for f in faults:
        if kind not in f.kinds:
            raise ValueError(f"a {kind} cell cannot have {type(f).__name__}")
    return faults
