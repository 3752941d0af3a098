"""Experiment logging: counterpart of ``xvr_tpu.cli.logging``. A wandb run
when ``wandb`` imports and ``WANDB_API_KEY`` is set, else a local JSONL run
under ``$XVR_LOG_DIR`` (default ``runs/``) / project / name."""

from __future__ import annotations

import json
import os
from pathlib import Path


class LocalRun:
    """A wandb.Run-like log that appends JSON lines to a file."""

    def __init__(self, project: str, name: str, config: dict, id: str | None = None):
        self.project = project
        self.name = name
        self.id = id or name
        root = Path(os.environ.get("XVR_LOG_DIR", "runs")) / project
        root.mkdir(parents=True, exist_ok=True)
        self.path = root / f"{self.name}.jsonl"
        with open(self.path, "a") as f:
            f.write(json.dumps({"event": "start", "config": _jsonable(config)}) + "\n")

    def log(self, metrics: dict):
        metrics = dict(metrics)
        fig = metrics.pop("imgs", None)
        if fig is not None:
            # a matplotlib figure: saved as a PNG beside the log
            figdir = self.path.with_suffix("") / "figures"
            figdir.mkdir(parents=True, exist_ok=True)
            out = figdir / f"{int(metrics.get('itr', len(list(figdir.glob('*.png'))))):07d}.png"
            fig.savefig(out, dpi=120)
            metrics["imgs"] = str(out)
        with open(self.path, "a") as f:
            f.write(json.dumps(_jsonable(metrics), default=str) + "\n")

    def finish(self):
        pass


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


def start_run(project: str, name: str, config: dict, id: str | None = None):
    """A wandb run when configured and importable, else a :class:`LocalRun`."""
    if os.environ.get("WANDB_API_KEY"):
        try:
            import wandb
        except ImportError:
            wandb = None
        if wandb is not None:
            wandb.login(key=os.environ["WANDB_API_KEY"])
            return wandb.init(project=project, name=name, config=config, id=id,
                              resume="must" if id is not None else None)
    return LocalRun(project, name, config, id)
