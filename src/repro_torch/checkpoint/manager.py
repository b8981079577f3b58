"""Atomic, versioned checkpointing of named tensors: the port of
`repro.checkpoint.manager`.

Layout:  <dir>/step_<N:08d>/   arrays.npz  tree.json   (+ .done marker)

The reference's layout, keyed by name where the reference numbers the
leaves of a pytree: a state is a dict of tensors, or of such dicts (the
training loop saves {"model": state_dict, "m": ..., "v": ..., "ef":
...}), and `arrays.npz` holds each tensor under its path ("m/embed").
bfloat16 tensors go to disk by their bits (int16), which
`repro_torch.interop` reads back the same way; `tree.json` names each
path's dtype and shape.  Writes go to a tmp dir first and are renamed
into place: a crash mid-save never corrupts the latest checkpoint, and a
step directory without `.done` is ignored.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

SEP = "/"


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}{SEP}"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _unflatten(like: dict, flat: dict, prefix: str = "") -> dict:
    return {key: (_unflatten(val, flat, f"{prefix}{key}{SEP}") if isinstance(val, dict)
                  else flat[f"{prefix}{key}"])
            for key, val in like.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: dict) -> str:
        flat = _flatten(tree)
        final = self.path(step)
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{name: _to_numpy(t) for name, t in flat.items()})
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump({"step": step, "tensors": {
                    name: {"dtype": _dtype_name(t), "shape": list(t.shape)}
                    for name, t in flat.items()}}, f)
            with open(os.path.join(tmp, ".done"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    # -- restore ------------------------------------------------------------
    def latest_step(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and \
                    os.path.exists(os.path.join(self.dir, name, ".done")):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, like: dict, step: int | None = None):
        """`like` gives the names, shapes, dtypes and devices; returns (a
        tree of new tensors read from disk, the step).  Raises if the
        checkpoint's names, shapes or dtypes differ from `like`'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.path(step)
        with open(os.path.join(path, "tree.json")) as f:
            meta = json.load(f)["tensors"]
        want = _flatten(like)
        if set(meta) != set(want):
            raise KeyError(f"checkpoint/model mismatch: missing {sorted(set(want) - set(meta))}, "
                           f"unexpected {sorted(set(meta) - set(want))}")
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for name, ref in want.items():
                info = meta[name]
                if info["dtype"] != _dtype_name(ref) or tuple(info["shape"]) != tuple(ref.shape):
                    raise ValueError(f"{name}: checkpoint has {info['dtype']} "
                                     f"{tuple(info['shape'])}, expected {_dtype_name(ref)} "
                                     f"{tuple(ref.shape)}")
                flat[name] = _from_numpy(data[name], info["dtype"]).to(ref.device)
        return _unflatten(like, flat), step

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.path(s), ignore_errors=True)
