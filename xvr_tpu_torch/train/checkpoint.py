"""Self-describing checkpoints (msgpack, single file), in the JAX layout.

Counterpart of ``xvr_tpu.train.checkpoint``: each file is one msgpack map
with the model weights in flax's tree (``model_state_dict``; see
:func:`xvr_tpu_torch.state.to_flax_params`), the optimizer state, the
iteration counter, the model number, a date stamp and the full resolved
config, so the checkpoint alone rebuilds the model and resumes its training
(``xvr_tpu_torch.cli restart``). Files written by either package load in the
other, the optimizer state included. Read and written by the port's own codec
(:mod:`xvr_tpu_torch.io.msgpack`), without ``msgpack`` or ``flax``.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

from ..io import msgpack


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def save_checkpoint(path, params, opt_state, itr: int, model_number: int, config: dict):
    """Write ``params`` (a flax-layout tree of NumPy arrays or tensors, as
    :func:`~xvr_tpu_torch.state.to_flax_params` gives) and ``opt_state`` (a
    tree of the same kinds: the trainer's optimizer state in optax's layout,
    :meth:`~xvr_tpu_torch.train.optim.AGCAdamMultiSteps.state_dict`, or
    ``{}`` for a checkpoint that only carries weights, which is all that
    ``load_model`` reads)."""
    payload = {
        "model_state_dict": params,
        "optimizer_state_dict": opt_state,
        "itr": int(itr),
        "model_number": int(model_number),
        "date": datetime.datetime.now().isoformat(),
        "config": _jsonable(config),
    }
    data = msgpack.serialize(payload)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path


def load_checkpoint(path) -> dict:
    return msgpack.restore(Path(path).read_bytes())


def latest_checkpoint(dirpath) -> Path | None:
    """The newest ``*.ckpt``/``*.pth`` file of a directory (a file is
    returned as is), or None."""
    dirpath = Path(dirpath)
    if dirpath.is_file():
        return dirpath
    candidates = sorted(dirpath.glob("*.ckpt")) + sorted(dirpath.glob("*.pth"))
    if not candidates:
        return None
    return max(candidates, key=lambda p: p.stat().st_mtime)
