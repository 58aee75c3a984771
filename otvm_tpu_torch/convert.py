"""Weights between the JAX package's variables and the port's state_dicts.

The JAX side holds {'params': ..., 'batch_stats': ...} nested dicts with
HWIO kernels and flax names (scale/bias/mean/var); the port holds the
original OTVM state_dict names with OIHW weights (weight/bias/
running_mean/running_var).  The name tables are this package's own copy of
the mapping (the JAX package's otvm_tpu/convert/torch_import.py encodes the
same names; it has none for the BN FBA trunk), built per stage, STM trunk
norm, FBA trunk (`arch`) and width scale.

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


def _bn_affine(t: Table, tk: str, path):
    """otvm_tpu.nn.resnet_bn.BNAffine: scale and bias, no statistics."""
    t[tk + ".weight"] = ("params", path + ("scale",), "vec")
    t[tk + ".bias"] = ("params", path + ("bias",), "vec")


def _fba_trunk(t: Table, arch: str, scale: int):
    """The encoder: GN-WS (WSConv kernels, GroupNorm32) or BN (linen
    Conv, BNAffine, a 3-conv stem; no width-scaled variant)."""
    e = ("encoder",)
    if arch == "resnet50_GN_WS":
        conv, norm, stem = _conv, _gn32, (1,)
        blocks = (3, 4, 6, 3) if scale == 1 else (1, 1, 1, 1)
    elif arch == "resnet50_BN" and scale == 1:
        conv, norm, stem, blocks = _linen_conv, _bn_affine, (1, 2, 3), (3, 4, 6, 3)
    else:
        raise KeyError(f"no FBA trunk {arch!r} at scale {scale}")
    for j in stem:
        conv(t, f"encoder.conv{j}", e + (f"conv{j}",))
        norm(t, f"encoder.bn{j}", e + (f"bn{j}",))
    for li, nb in enumerate(blocks, start=1):
        for i in range(nb):
            bk, bp = f"encoder.layer{li}.{i}", e + (f"layer{li}", str(i))
            for j in (1, 2, 3):
                conv(t, f"{bk}.conv{j}", bp + (f"conv{j}",))
                norm(t, f"{bk}.bn{j}", bp + (f"bn{j}",))
            if i == 0:
                conv(t, f"{bk}.downsample.0", bp + ("downsample_conv",))
                norm(t, f"{bk}.downsample.1", bp + ("downsample_bn",))


def fba_table(refinement: bool, scale: int = 1, arch: str = "resnet50_GN_WS") -> Table:
    t: Table = {}
    _fba_trunk(t, arch, scale)
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
        sd[tk] = torch.from_numpy(np.array(w, order="C"))   # a copy: no aliasing
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
        node[path[-1]] = np.array(w, order="C")          # a copy: no aliasing
    return out


def stm_from_jax(stm_vars: Mapping, hdim: int = 16, scale: int = 1) -> Dict[str, torch.Tensor]:
    """STM variables without batch_stats are the GN trunk."""
    norm = "frozen_bn" if stm_vars.get("batch_stats") else "gn"
    return _apply_from_jax(stm_vars, stm_table(hdim, scale, norm))


def fba_from_jax(fba_vars: Mapping, refinement: bool = True, scale: int = 1,
                 arch: str = "resnet50_GN_WS") -> Dict[str, torch.Tensor]:
    return _apply_from_jax(fba_vars, fba_table(refinement, scale, arch))


def from_jax(stm_vars: Mapping, fba_vars: Mapping, stage: int = 4, scale: int = 1,
             arch: str = "resnet50_GN_WS"
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX variables (nested dicts of arrays) -> the port's (STM, FBA)
    state_dicts for a stage and FBA trunk."""
    refinement = stage > 2
    return (stm_from_jax(stm_vars, 16 if refinement else -1, scale),
            fba_from_jax(fba_vars, refinement, scale, arch))


def to_jax(stm_state: Mapping[str, torch.Tensor], fba_state: Mapping[str, torch.Tensor],
           stage: int = 4, scale: int = 1, arch: str = "resnet50_GN_WS"
           ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """The port's (STM, FBA) state_dicts -> JAX variables of numpy arrays."""
    refinement = stage > 2
    norm = "frozen_bn" if any(k.endswith("running_mean") for k in stm_state) else "gn"
    return (_apply_to_jax(stm_state, stm_table(16 if refinement else -1, scale, norm)),
            _apply_to_jax(fba_state, fba_table(refinement, scale, arch)))


# ---------------------------------------------------------------------------
# per-parameter training state: gradients, RAdam moments
# ---------------------------------------------------------------------------

def _param_tables(stage: int, scale: int, arch: str = "resnet50_GN_WS"
                  ) -> Tuple[Table, Table]:
    """The tables' trainable entries: the JAX 'params' collection.  A
    trunk norm's parameters have the same names under either norm."""
    keep = lambda t: {k: v for k, v in t.items() if v[0] == "params"}
    refinement = stage > 2
    return (keep(stm_table(16 if refinement else -1, scale)),
            keep(fba_table(refinement, scale, arch)))


def params_to_jax(stm_tensors: Mapping[str, torch.Tensor],
                  fba_tensors: Mapping[str, torch.Tensor], stage: int = 4, scale: int = 1,
                  arch: str = "resnet50_GN_WS") -> Dict[str, dict]:
    """Per-parameter tensors of the port (gradients, optimizer moments, or
    the parameters themselves), keyed by parameter name, -> the JAX
    package's params tree {'stm': ..., 'fba': ...}, with the weights'
    per-leaf layout transform.  Strict: every parameter, nothing else."""
    stm_t, fba_t = _param_tables(stage, scale, arch)
    return {"stm": _apply_to_jax(stm_tensors, stm_t).get("params", {}),
            "fba": _apply_to_jax(fba_tensors, fba_t).get("params", {})}


def params_from_jax(tree: Mapping[str, Mapping], stage: int = 4, scale: int = 1,
                    arch: str = "resnet50_GN_WS"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """params_to_jax's inverse: a JAX params tree {'stm': ..., 'fba': ...}
    (parameters, gradients or moments) -> (STM, FBA) tensors by name."""
    stm_t, fba_t = _param_tables(stage, scale, arch)
    return (_apply_from_jax({"params": tree["stm"]}, stm_t),
            _apply_from_jax({"params": tree["fba"]}, fba_t))


def _named_state(optimizer, module: torch.nn.Module, key: str) -> Dict[str, torch.Tensor]:
    state = {}
    for name, p in module.named_parameters():
        if key not in optimizer.state.get(p, {}):
            raise KeyError(f"the optimizer holds no {key} for {name}")
        state[name] = optimizer.state[p][key]
    return state


def radam_state_to_jax(optimizer, stm: torch.nn.Module, fba: torch.nn.Module,
                       stage: int = 4, scale: int = 1) -> Tuple[int, dict, dict]:
    """The port's RAdam state over both networks (the optimizer of stages 1
    and 4 and of trimap training, which holds every parameter, after its
    first step) -> (step, exp_avg, exp_avg_sq) with the moments as JAX
    params trees: the fields of otvm_tpu's RAdamState.  Strict: every
    parameter needs its moments."""
    moments = [params_to_jax(_named_state(optimizer, stm, key), _named_state(optimizer, fba, key),
                             stage, scale, fba.arch) for key in ("exp_avg", "exp_avg_sq")]
    return optimizer.param_groups[0]["step"], moments[0], moments[1]


def radam_state_from_jax(optimizer, stm: torch.nn.Module, fba: torch.nn.Module, step: int,
                         exp_avg: Mapping, exp_avg_sq: Mapping, stage: int = 4,
                         scale: int = 1) -> None:
    """Loads the fields of otvm_tpu's RAdamState into the port's RAdam,
    whose parameters are both networks' (strict both ways)."""
    owned = {id(p) for p in optimizer.param_groups[0]["params"]}
    if len(owned) != sum(1 for net in (stm, fba) for _ in net.parameters()):
        raise KeyError("the optimizer's parameters are not both networks' parameters")
    m_stm, m_fba = params_from_jax(exp_avg, stage, scale, fba.arch)
    v_stm, v_fba = params_from_jax(exp_avg_sq, stage, scale, fba.arch)
    for module, m, v in ((stm, m_stm, v_stm), (fba, m_fba, v_fba)):
        for name, p in module.named_parameters():
            if id(p) not in owned:
                raise KeyError(f"{name} is not a parameter of the optimizer")
            optimizer.state[p] = {"exp_avg": m[name].to(p.device),
                                  "exp_avg_sq": v[name].to(p.device)}
    optimizer.param_groups[0]["step"] = int(step)


# buffers of the released joint checkpoints that are regenerated in code
_JOINT_SKIP = ("IMG_MEAN", "IMG_STD", "LAPLOSS.KERNEL", "LOSS_TRIMAP.weight",
               "trimap.IMG_MEAN", "trimap.IMG_STD", "trimap.LOSS.weight")


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A released OTVM checkpoint -> the port's (STM, FBA) state_dicts: a
    joint one (s3_OTVM.pth / s4_OTVM.pth: 'NET.*' alpha + 'trimap.model.*'
    STM), or one network alone, as the JAX package's
    import_torch_checkpoint reads them (STM_weights.pth and the stage-1
    trimap files: 'Encoder_M.*' present; else an alpha network), the
    other dict then empty.  The GN-WS FBA trunk only: the reference ships
    no resnet50_BN checkpoint, and one (its 3-conv stem) is refused, as the
    JAX converter refuses it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and not isinstance(sd["state_dict"], torch.Tensor):
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    if not any(k.startswith(("NET.", "trimap.model.")) for k in sd):
        net = "trimap.model." if any(k.startswith("Encoder_M.") for k in sd) else "NET."
        sd = {net + k: v for k, v in sd.items()}
    stm_sd, fba_sd = {}, {}
    for k, v in sd.items():
        if k in _JOINT_SKIP:
            continue
        if k.startswith("trimap.model."):
            stm_sd[k[len("trimap.model."):]] = v
        elif k.startswith("NET."):
            if k.startswith("NET.encoder.conv2."):
                raise KeyError("a resnet50_BN FBA checkpoint: load_pth reads GN-WS ones only")
            fba_sd[k[len("NET."):]] = v
        else:
            raise KeyError(f"unexpected checkpoint key {k}")
    return stm_sd, fba_sd
