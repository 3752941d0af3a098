"""The trainer's optimizer, written out: optax's
``MultiSteps(chain(adaptive_grad_clip(0.01, eps=1e-3), adam(schedule)), every_k)``
with optax 0.2.6's arithmetic, on a dict of named tensors.

* **MultiSteps** keeps the running mean of the gradients of the current
  accumulation window, ``acc += (g - acc) / (mini_step + 1)``. On the
  ``every_k``-th gradient the inner chain sees that mean and the parameters
  of that moment, its update is applied and the mean is reset; in between
  the parameters do not move.
* **Adaptive gradient clipping** scales each unit of the mean gradient whose
  norm exceeds ``clipping * max(|unit of the parameter|, eps)`` down to that
  norm. The units are optax's for the JAX package's (flax) layout: the whole
  tensor where the squeezed rank is <= 1; for a dense kernel each output
  column (flax ``(in, out)`` axis 0 is torch ``(out, in)`` axis 1); for a
  convolution kernel each output filter (flax HWIO axes (0, 1, 2) are torch
  OIHW axes (1, 2, 3)).
* **Adam**: ``mu``, ``nu`` as exponential moving averages, bias correction by
  the incremented count, ``mu_hat / (sqrt(nu_hat) + eps)`` with eps 1e-8
  outside the root (eps_root 0), times ``-schedule(count)``, where the schedule
  reads the count of inner updates *before* it increments (the first update
  of a run takes ``schedule(0)``).

:meth:`AGCAdamMultiSteps.state_dict` lays the state out as
``flax.serialization.to_state_dict`` lays out optax's state, with the
moments in the flax parameter tree (:func:`xvr_tpu_torch.state.to_flax_params`),
so that a checkpoint's optimizer state restores in either package.
"""

from __future__ import annotations

import numpy as np
import torch


def agc_axes(shape) -> tuple[int, ...] | None:
    """The axes of a torch-layout tensor that one AGC unit spans (None: the
    whole tensor), following optax's ``unitwise_norm`` on the flax layout."""
    if sum(1 for n in shape if n != 1) <= 1:
        return None
    if len(shape) == 2:
        return (1,)
    if len(shape) == 4:
        return (1, 2, 3)
    raise ValueError(f"no AGC unit for a parameter of shape {tuple(shape)}")


def _unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    axes = agc_axes(x.shape)
    sq = x * x
    s = sq.sum() if axes is None else sq.sum(dim=axes, keepdim=True)
    return torch.sqrt(s).expand(x.shape)


# the trainer's constants: adaptive_grad_clip(0.01, eps=1e-3) and adam's
# defaults (eps_root 0)
CLIPPING, AGC_EPS = 0.01, 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8


class AGCAdamMultiSteps:
    """Functional optimizer over ``{name: tensor}`` dicts: :meth:`init` gives
    the state, :meth:`step` applies one gradient to the parameters in place
    (an update every ``every_k`` calls) and advances the state."""

    def __init__(self, schedule, every_k: int = 1):
        self.schedule = schedule
        self.every_k = int(every_k)

    def init(self, params: dict) -> dict:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return dict(mini_step=0, gradient_step=0, adam_count=0, schedule_count=0,
                    mu={k: v.clone() for k, v in zeros.items()},
                    nu={k: v.clone() for k, v in zeros.items()}, acc_grads=zeros)

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> bool:
        """Accumulate ``grads`` and, on the ``every_k``-th call, update
        ``params`` in place. -> whether the parameters moved."""
        n = state["mini_step"]
        acc = state["acc_grads"]
        f = np.float32
        for k, g in grads.items():
            acc[k] = acc[k] + (g - acc[k]) / f(n + 1)
        if n != self.every_k - 1:
            state["mini_step"] = n + 1
            return False
        count = state["adam_count"] + 1
        bc1 = f(1) - np.power(f(B1), f(count), dtype=f)
        bc2 = f(1) - np.power(f(B2), f(count), dtype=f)
        lr = f(-self.schedule(state["schedule_count"]))
        for k, p in params.items():
            g = acc[k]
            # adaptive gradient clipping, unit-wise
            g_norm = _unitwise_norm(g)
            max_norm = CLIPPING * torch.clamp(_unitwise_norm(p), min=AGC_EPS)
            clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6))
            g = torch.where(g_norm < max_norm, g, clipped)
            # adam
            mu = (1 - B1) * g + B1 * state["mu"][k]
            nu = (1 - B2) * (g * g) + B2 * state["nu"][k]
            state["mu"][k], state["nu"][k] = mu, nu
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.add_(lr * upd)
            acc[k] = torch.zeros_like(g)
        state.update(mini_step=0, gradient_step=state["gradient_step"] + 1, adam_count=count,
                     schedule_count=state["schedule_count"] + 1)
        return True

    # -- optax's layout ------------------------------------------------------
    @staticmethod
    def state_dict(state: dict, to_tree) -> dict:
        """The state as ``flax.serialization.to_state_dict`` writes optax's
        ``MultiStepsState``; ``to_tree`` maps a ``{name: tensor}`` dict to
        the flax parameter tree."""
        def i32(n):
            return np.asarray(n, dtype=np.int32)

        return {
            "mini_step": i32(state["mini_step"]),
            "gradient_step": i32(state["gradient_step"]),
            "inner_opt_state": {
                "0": {},
                "1": {"0": {"count": i32(state["adam_count"]), "mu": to_tree(state["mu"]),
                            "nu": to_tree(state["nu"])},
                      "1": {"count": i32(state["schedule_count"])}},
            },
            "acc_grads": to_tree(state["acc_grads"]),
            "skip_state": {},
        }

    @staticmethod
    def load_state_dict(sd: dict, from_tree, like: dict) -> dict:
        """Inverse of :meth:`state_dict`: ``from_tree`` maps a flax parameter
        tree back to ``{name: tensor}``; tensors take the dtype and device
        of ``like``'s (the parameters)."""
        def tensors(tree):
            out = from_tree(tree)
            return {k: out[k].to(dtype=v.dtype, device=v.device) for k, v in like.items()}

        adam, sched = sd["inner_opt_state"]["1"]["0"], sd["inner_opt_state"]["1"]["1"]
        return dict(
            mini_step=int(np.asarray(sd["mini_step"])),
            gradient_step=int(np.asarray(sd["gradient_step"])),
            adam_count=int(np.asarray(adam["count"])),
            schedule_count=int(np.asarray(sched["count"])),
            mu=tensors(adam["mu"]), nu=tensors(adam["nu"]), acc_grads=tensors(sd["acc_grads"]),
        )
