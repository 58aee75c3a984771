"""Weights between the JAX package's variables and the port's state_dicts.

The JAX side holds {'params': ..., 'batch_stats': ...} nested dicts with
HWIO kernels and flax names (scale/bias/mean/var); the port holds the
original OTVM state_dict names with OIHW weights (weight/bias/
running_mean/running_var).  The name tables are this package's own copy of
the mapping (the JAX package's otvm_tpu/convert/torch_import.py encodes the
same names), built per stage, STM trunk norm and width scale.

Both directions are strict: no port key is left unfilled and no JAX leaf is
left unused.  Entries marked 'const' (BN num_batches_tracked, the STM
encoders' mean/std buffers) have no JAX counterpart and are regenerated.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .models.stm import IMAGENET_MEAN, IMAGENET_STD

# torch key -> (collection, jax path, kind); kind: 'conv' (OIHW <-> HWIO),
# 'vec' (1-D copy) or 'const' (regenerated; the path holds no JAX leaf)
Table = Dict[str, Tuple[str, Tuple[str, ...], str]]

_CONSTS = {
    "num_batches_tracked": lambda: np.zeros((), np.int64),
    "mean": lambda: np.asarray(IMAGENET_MEAN, np.float32).reshape(1, 3, 1, 1),
    "std": lambda: np.asarray(IMAGENET_STD, np.float32).reshape(1, 3, 1, 1),
}


def _conv(t: Table, tk: str, path, bias: bool = False):
    t[tk + ".weight"] = ("params", path + ("kernel",), "conv")
    if bias:
        t[tk + ".bias"] = ("params", path + ("bias",), "vec")


def _linen_conv(t: Table, tk: str, path, bias: bool = False):
    """otvm_tpu.nn.layers.Conv wraps nn.Conv under the child name 'conv'."""
    _conv(t, tk, path + ("conv",), bias)


def _gn32(t: Table, tk: str, path):
    """otvm_tpu.nn.layers.GroupNorm32 wraps nn.GroupNorm as 'gn'."""
    t[tk + ".weight"] = ("params", path + ("gn", "scale"), "vec")
    t[tk + ".bias"] = ("params", path + ("gn", "bias"), "vec")


def _trunk_norm(t: Table, tk: str, path, norm: str):
    t[tk + ".weight"] = ("params", path + ("scale",), "vec")
    t[tk + ".bias"] = ("params", path + ("bias",), "vec")
    if norm == "frozen_bn":
        t[tk + ".running_mean"] = ("batch_stats", path + ("mean",), "vec")
        t[tk + ".running_var"] = ("batch_stats", path + ("var",), "vec")
        t[tk + ".num_batches_tracked"] = ("", (), "const")


def _stm_trunk(t: Table, tk: str, path, blocks, norm: str):
    _linen_conv(t, tk + ".conv1", path + ("conv1",))
    _trunk_norm(t, tk + ".bn1", path + ("bn1",), norm)
    for li, nb in enumerate(blocks, start=1):
        for i in range(nb):
            bk, bp = f"{tk}.res{li + 1}.{i}", path + (f"layer{li}", str(i))
            for j in (1, 2, 3):
                _linen_conv(t, f"{bk}.conv{j}", bp + (f"conv{j}",))
                _trunk_norm(t, f"{bk}.bn{j}", bp + (f"bn{j}",), norm)
            if i == 0:
                _linen_conv(t, f"{bk}.downsample.0", bp + ("downsample_conv",))
                _trunk_norm(t, f"{bk}.downsample.1", bp + ("downsample_bn",), norm)
    t[tk + ".mean"] = ("", (), "const")
    t[tk + ".std"] = ("", (), "const")


def stm_table(hdim: int, scale: int = 1, norm: str = "frozen_bn") -> Table:
    t: Table = {}
    blocks = (3, 4, 6) if scale == 1 else (1, 1, 1)
    extra = ("m", "o", "a", "h") if hdim > 0 else ("m", "o")
    for x in extra:
        _linen_conv(t, f"Encoder_M.conv1_{x}", (f"conv1_{x}",))
    _stm_trunk(t, "Encoder_M", ("Encoder_M",), blocks, norm)
    _stm_trunk(t, "Encoder_Q", ("Encoder_Q",), blocks, norm)
    for side in ("KV_M_r4", "KV_Q_r4"):
        _linen_conv(t, f"{side}.Key", (side, "Key"), bias=True)
        _linen_conv(t, f"{side}.Value", (side, "Value"), bias=True)
    d = ("Decoder",)
    _linen_conv(t, "Decoder.convFM", d + ("convFM",), bias=True)
    for c in ("conv1", "conv2"):
        _linen_conv(t, f"Decoder.ResMM.{c}", d + ("ResMM", c), bias=True)
    for rf in ("RF3", "RF2"):
        _linen_conv(t, f"Decoder.{rf}.convFS", d + (rf, "convFS"), bias=True)
        for rb in ("ResFS", "ResMM"):
            for c in ("conv1", "conv2"):
                _linen_conv(t, f"Decoder.{rf}.{rb}.{c}", d + (rf, rb, c), bias=True)
    _linen_conv(t, "Decoder.pred", d + ("pred",), bias=True)
    return t


def fba_table(refinement: bool, scale: int = 1) -> Table:
    t: Table = {}
    e = ("encoder",)
    _conv(t, "encoder.conv1", e + ("conv1",))
    _gn32(t, "encoder.bn1", e + ("bn1",))
    blocks = (3, 4, 6, 3) if scale == 1 else (1, 1, 1, 1)
    for li, nb in enumerate(blocks, start=1):
        for i in range(nb):
            bk, bp = f"encoder.layer{li}.{i}", e + (f"layer{li}", str(i))
            for j in (1, 2, 3):
                _conv(t, f"{bk}.conv{j}", bp + (f"conv{j}",))
                _gn32(t, f"{bk}.bn{j}", bp + (f"bn{j}",))
            if i == 0:
                _conv(t, f"{bk}.downsample.0", bp + ("downsample_conv",))
                _gn32(t, f"{bk}.downsample.1", bp + ("downsample_bn",))
    d = ("decoder",)
    conv_gn = [(f"ppm.{i}.1", f"ppm.{i}.2", f"ppm{i}") for i in range(4)] + [
        ("conv_up1.0", "conv_up1.1", "up1_0"), ("conv_up1.3", "conv_up1.4", "up1_1"),
        ("conv_up2.0", "conv_up2.1", "up2"), ("conv_up3.0", "conv_up3.1", "up3")]
    for conv_k, gn_k, jname in conv_gn:
        _conv(t, f"decoder.{conv_k}", d + (jname, "conv"), bias=True)
        _gn32(t, f"decoder.{gn_k}", d + (jname, "norm"))
    for tk, jname in (("0", "up4_0"), ("2", "up4_1"), ("4", "up4_2")):
        _linen_conv(t, f"decoder.conv_up4.{tk}", d + (jname,), bias=True)
    if refinement:
        r = ("refine",)
        _conv(t, "refine.conv1.0", r + ("conv1", "conv"), bias=True)
        _gn32(t, "refine.conv1.1", r + ("conv1", "norm"))
        for lb in ("layer1", "layer2"):
            for j in (1, 2):
                _conv(t, f"refine.{lb}.conv{j}", r + (lb, f"conv{j}"))
                _gn32(t, f"refine.{lb}.bn{j}", r + (lb, f"bn{j}"))
        for tk, jname in (("0", "pred_0"), ("2", "pred_1"), ("4", "pred_2")):
            _linen_conv(t, f"refine.pred.{tk}", r + (jname,), bias=True)
    return t


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _apply_from_jax(variables: Mapping, table: Table) -> Dict[str, torch.Tensor]:
    leaves = {(coll,) + path: leaf for coll, tree in variables.items()
              for path, leaf in _leaves(tree)}
    sd, used = {}, set()
    for tk, (coll, path, kind) in table.items():
        if kind == "const":
            sd[tk] = torch.from_numpy(_CONSTS[tk.rsplit(".", 1)[1]]())
            continue
        key = (coll,) + path
        if key not in leaves:
            raise KeyError(f"JAX variables lack {'/'.join(key)} (for {tk})")
        used.add(key)
        w = np.asarray(leaves[key], dtype=np.float32)
        if kind == "conv":
            w = np.transpose(w, (3, 2, 0, 1))       # HWIO -> OIHW
        sd[tk] = torch.from_numpy(np.ascontiguousarray(w))
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unused:
        raise KeyError(f"JAX leaves with no port key ({len(unused)}): {unused[:8]}")
    return sd


def _apply_to_jax(state_dict: Mapping[str, torch.Tensor], table: Table) -> Dict[str, dict]:
    extra = sorted(set(state_dict) - set(table))
    if extra:
        raise KeyError(f"port keys with no JAX leaf ({len(extra)}): {extra[:8]}")
    out: Dict[str, dict] = {}
    for tk, (coll, path, kind) in table.items():
        if tk not in state_dict:
            raise KeyError(f"state_dict lacks {tk}")
        if kind == "const":
            continue
        w = state_dict[tk].detach().cpu().float().numpy()
        if kind == "conv":
            w = np.transpose(w, (2, 3, 1, 0))       # OIHW -> HWIO
        node = out.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(w)
    return out


def stm_from_jax(stm_vars: Mapping, hdim: int = 16, scale: int = 1) -> Dict[str, torch.Tensor]:
    """STM variables without batch_stats are the GN trunk."""
    norm = "frozen_bn" if stm_vars.get("batch_stats") else "gn"
    return _apply_from_jax(stm_vars, stm_table(hdim, scale, norm))


def fba_from_jax(fba_vars: Mapping, refinement: bool = True,
                 scale: int = 1) -> Dict[str, torch.Tensor]:
    return _apply_from_jax(fba_vars, fba_table(refinement, scale))


def from_jax(stm_vars: Mapping, fba_vars: Mapping, stage: int = 4, scale: int = 1
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX variables (nested dicts of arrays) -> the port's (STM, FBA)
    state_dicts for a stage."""
    refinement = stage > 2
    return (stm_from_jax(stm_vars, 16 if refinement else -1, scale),
            fba_from_jax(fba_vars, refinement, scale))


def to_jax(stm_state: Mapping[str, torch.Tensor], fba_state: Mapping[str, torch.Tensor],
           stage: int = 4, scale: int = 1) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """The port's (STM, FBA) state_dicts -> JAX variables of numpy arrays."""
    refinement = stage > 2
    norm = "frozen_bn" if any(k.endswith("running_mean") for k in stm_state) else "gn"
    return (_apply_to_jax(stm_state, stm_table(16 if refinement else -1, scale, norm)),
            _apply_to_jax(fba_state, fba_table(refinement, scale)))


# buffers of the released joint checkpoints that are regenerated in code
_JOINT_SKIP = ("IMG_MEAN", "IMG_STD", "LAPLOSS.KERNEL", "LOSS_TRIMAP.weight",
               "trimap.IMG_MEAN", "trimap.IMG_STD", "trimap.LOSS.weight")


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A released joint OTVM checkpoint (s3_OTVM.pth / s4_OTVM.pth: 'NET.*'
    alpha + 'trimap.model.*' STM) -> the port's (STM, FBA) state_dicts."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and not isinstance(sd["state_dict"], torch.Tensor):
        sd = sd["state_dict"]
    stm_sd, fba_sd = {}, {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k in _JOINT_SKIP:
            continue
        if k.startswith("trimap.model."):
            stm_sd[k[len("trimap.model."):]] = v
        elif k.startswith("NET."):
            fba_sd[k[len("NET."):]] = v
        else:
            raise KeyError(f"unexpected checkpoint key {k}")
    return stm_sd, fba_sd
