"""Train-state checkpoints (torch.save), counterpart of
otvm_tpu/utils/checkpoint.py.

  * save_train_state / restore_train_state: both networks, the optimizer's
    state and the step, so a run resumes where it stopped (the reference
    saves but never resumes, train.py:127);
  * restore_params_only: the networks alone, for chaining stages (each
    stage starts a fresh optimizer); a key the checkpoint lacks (stage 3's
    refinement and extra memory-encoder convs after stage 2) keeps its
    fresh init;
  * import_torch_checkpoint: a released joint .pth (convert.load_pth).
"""
from __future__ import annotations

import os
import tempfile

import torch

from ..convert import load_pth as import_torch_checkpoint  # noqa: F401  (the released .pth)


def save_train_state(path: str, state) -> None:
    """One file: the networks' state_dicts, the optimizer's and the step.
    Written beside `path` first and moved into place, so a run stopped
    while saving keeps the previous checkpoint."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(dict(stm=state.stm.state_dict(), fba=state.fba.state_dict(),
                        optimizer=state.optimizer.state_dict(), step=state.step), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, template):
    """Loads a save_train_state file strictly into `template` (a TrainState
    of the same stage and model, e.g. a fresh init_train_state) and
    returns it, at the saved step.  Everything loads into the template's
    own tensors (modules and RAdam copy in place), so a train step's CUDA
    graph of that state stays valid and replays from the loaded state."""
    ckpt = _load(path)
    template.stm.load_state_dict(ckpt["stm"], strict=True)
    template.fba.load_state_dict(ckpt["fba"], strict=True)
    template.optimizer.load_state_dict(ckpt["optimizer"])
    template.step = int(ckpt["step"])
    return template


def restore_params_only(path: str, template, nets=("stm", "fba")):
    """The weights of `nets` from a save_train_state file into `template`,
    its optimizer untouched; keys the file lacks keep the template's
    values (reported), keys the template lacks are ignored."""
    ckpt = _load(path)
    missing = []
    for name in nets:
        result = getattr(template, name).load_state_dict(ckpt.get(name, {}), strict=False)
        missing += [f"{name}.{k}" for k in result.missing_keys]
    if missing:
        print(f"[checkpoint] {len(missing)} keys not in {path}, keeping fresh init "
              f"(first: {missing[:4]})")
    return template
