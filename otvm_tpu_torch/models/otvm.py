"""Joint OTVM model, counterpart of otvm_tpu/models/otvm.py.

`eval_frame_step` is one frame of joint stage-3/4 inference (alpha
EvalModel.forward, models/alpha/model.py:391-512): segment with the memory
bank -> softmax -> trimap features (argmax, JFA EDT, clicks) -> FBA with
refinement -> memorize -> bank update.  Flags are Python bools and the bank
count a host int, so a frame is enqueued on the device without waiting for
it.  `eval_chunk_step` runs T frames of it in one call, `alpha_predict` is
FBA on a given trimap (stages 1-2), `trimap_eval_step` the STM alone
(stage-1 trimap propagation).  `joint_train_forward` (alpha
FullModel.forward, stages 1-4) and
`trimap_train_forward` (the stage-1 trimap FullModel) are the training
forwards with their losses.  Arrays are NHWC, as in the JAX package.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from .. import resolve_device, set_fp32_numerics
from ..nn.edt import trimap_clicks
from ..nn.layers import freeze_for_inference, init_flax_style
from ..train import losses as L
from ..train.losses import argmax_small
from .fba import FBA
from .memory import MemoryBank, init_bank, update_bank
from .stm import KEY_DIM, STM, VAL_DIM, normalize_image


def make_trimap_features(tri3: torch.Tensor, exact_edt: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tri3 [B, H, W, 3] soft trimap -> (feats8 [B, H, W, 8], trimask
    [B, H, W, 1]).  feats8 = [bg clicks x3, fg clicks x3, soft bg, soft fg];
    trimask = the hard unknown region (argmax == 1).  exact_edt: the clicks
    from the exact EDT instead of the JFA."""
    am = argmax_small(tri3)
    t2 = torch.stack([(am == 0), (am == 2)], dim=-1).float()
    clicks = trimap_clicks(t2, exact=exact_edt)
    soft = torch.stack([tri3[..., 0], tri3[..., 2]], dim=-1)
    feats = torch.cat([clicks.to(tri3.dtype), soft], dim=-1)
    trimask = (am == 1).to(tri3.dtype)[..., None]
    return feats, trimask


def make_models(stage: int = 4, scale: int = 1, stm_norm: str = "frozen_bn",
                arch: str = "resnet50_GN_WS") -> Tuple[STM, FBA]:
    """The (STM, FBA) pair of a stage, FBA on the `arch` trunk, on the CPU,
    with torch's default init."""
    refinement = stage > 2
    return (STM(hdim=16 if refinement else -1, scale=scale, norm=stm_norm),
            FBA(refinement=refinement, scale=scale, arch=arch))


def init_models(seed: int = 0, stage: int = 4, scale: int = 1, stm_norm: str = "frozen_bn",
                arch: str = "resnet50_GN_WS") -> Tuple[STM, FBA]:
    """make_models with flax-default random weights drawn from `seed`."""
    stm, fba = make_models(stage, scale, stm_norm, arch)
    g = torch.Generator().manual_seed(seed)
    init_flax_style(stm, g)
    init_flax_style(fba, g)
    return stm, fba


def serving_models(device, dtype: torch.dtype = torch.float32, scale: int = 1,
                   weights: Optional[Tuple[Dict, Dict]] = None) -> Tuple[STM, FBA]:
    """Stage-4 (STM, FBA) served on `device` in `dtype` (frozen for
    inference, no gradients): random weights from seed 0, or `weights`
    (STM and FBA state_dicts).  fp32 turns TF32 off (set_fp32_numerics)."""
    if weights is None:
        stm, fba = init_models(seed=0, stage=4, scale=scale)
    else:
        stm, fba = make_models(4, scale)
        stm.load_state_dict(weights[0], strict=True)
        fba.load_state_dict(weights[1], strict=True)
    if dtype == torch.float32:
        set_fp32_numerics()
    serve = lambda m: freeze_for_inference(m.to(device, dtype).eval().requires_grad_(False))
    return serve(stm), serve(fba)


class EvalOutput(NamedTuple):
    bank: MemoryBank
    alpha: torch.Tensor     # [B, H, W, 1] (uint8 with wire_u8_out)
    trimap: torch.Tensor    # [B, H, W, 3] (uint8 argmax label [B, H, W] with wire_u8_out)


@torch.no_grad()
def eval_frame_step(stm: STM, fba: FBA, bank: MemoryBank, frame01: torch.Tensor,
                    first_trimap3: torch.Tensor, first_frame: bool, memorize: bool,
                    last_frame: bool, max_memory_num: int = 5, wire_u8_out: bool = False,
                    memory_impl: Optional[str] = None, exact_edt: bool = False) -> EvalOutput:
    """One frame of streaming joint inference, on the device of its inputs.

    frame01 [B, H, W, 3] in [0, 1] (or uint8 0..255, decoded here in fp32
    and cast to the serving dtype), H and W multiples of 32.
    first_trimap3 [B, H, W, 3]: the GT trimap, read only on the first frame.
    The bank is updated in place.  memory_impl goes to memory_read (None:
    the kernel on CUDA, the plain version on the CPU); exact_edt to
    make_trimap_features."""
    if frame01.dtype == torch.uint8:
        frame01 = (frame01.float() / 255.0).to(first_trimap3.dtype)
    refinement = fba.refinement
    if first_frame:
        trimap3 = first_trimap3
    else:
        logits = stm.segment(frame01, bank.keys, bank.values, bank.slot_mask,
                             memory_impl=memory_impl)
        trimap3 = torch.softmax(logits, dim=-1)

    feats8, _ = make_trimap_features(trimap3, exact_edt)
    x11 = torch.cat([normalize_image(frame01), feats8], dim=-1)
    out7, hid, rout7, rtri = fba(x11, frame01, feats8[..., -2:])
    alpha = (rout7 if refinement else out7)[..., 0:1]
    # the refinement's trimap replaces the propagated one for BOTH output
    # and memorization, the first frame included (models/alpha/model.py:459-460)
    out_trimap = torch.softmax(rtri, dim=-1) if refinement else trimap3

    if not last_frame:
        kwargs = dict(alpha=alpha[..., 0], hidden=hid) if stm.hdim > 0 else {}
        k, v = stm.memorize(frame01, out_trimap[..., 1], out_trimap[..., 2], **kwargs)
        bank = update_bank(bank, k, v, first_frame, memorize, max_memory_num)
    if wire_u8_out:
        # torch.round rounds half to even, as jnp.round does
        alpha_u8 = torch.round(alpha.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        tri_label = torch.argmax(out_trimap, dim=-1).to(torch.uint8)
        return EvalOutput(bank, alpha_u8, tri_label)
    return EvalOutput(bank, alpha, out_trimap)


@torch.no_grad()
def eval_chunk_step(stm: STM, fba: FBA, bank: MemoryBank, frames01: torch.Tensor,
                    first_trimap3: torch.Tensor, first_flags: Sequence[bool],
                    memorize_flags: Sequence[bool], last_flags: Sequence[bool],
                    max_memory_num: int = 5, exact_edt: bool = False,
                    memory_impl: Optional[str] = None, graphs=None
                    ) -> Tuple[MemoryBank, torch.Tensor, torch.Tensor]:
    """T frames of `eval_frame_step` in one call, with per-frame flags:
    the per-frame protocol, frame for frame (JAX's lax.scan over the same
    body).  frames01 [T, B, H, W, 3], uint8 or in [0, 1].  Returns (bank,
    alphas [T, B, H, W, 1], trimaps [T, B, H, W, 3]); as in JAX, no
    wire_u8_out on this path.  graphs: a `models.graphs.FrameStepGraphs`
    of (stm, fba), whose graphs then serve the frames (each frame's
    outputs are copied out before the next replay overwrites them)."""
    step = functools.partial(eval_frame_step, stm, fba) if graphs is None else graphs
    alphas, trimaps = [], []
    for frame, first, mem, last in zip(frames01, first_flags, memorize_flags, last_flags):
        out = step(bank, frame, first_trimap3, first, mem, last, max_memory_num,
                   memory_impl=memory_impl, exact_edt=exact_edt)
        bank = out.bank
        alphas.append(out.alpha if graphs is None else out.alpha.clone())
        trimaps.append(out.trimap if graphs is None else out.trimap.clone())
    return bank, torch.stack(alphas), torch.stack(trimaps)


@torch.no_grad()
def alpha_predict(fba: FBA, frame01: torch.Tensor, trimap3: torch.Tensor,
                  exact_edt: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """FBA on a given trimap (the stage-1/2 eval, models/alpha/model.py:419,
    456-457; the trimap network is not run): frame01 [B, H, W, 3], uint8
    (decoded in fp32, then cast to trimap3's dtype) or in [0, 1]; trimap3
    [B, H, W, 3].  Returns (alpha [B, H, W, 1], fba7 [B, H, W, 7]): the
    refinement head's where the network has one, else the decoder's."""
    if frame01.dtype == torch.uint8:
        frame01 = (frame01.float() / 255.0).to(trimap3.dtype)
    feats8, _ = make_trimap_features(trimap3, exact_edt)
    x11 = torch.cat([normalize_image(frame01), feats8], dim=-1)
    out7, _, rout7, _ = fba(x11, frame01, feats8[..., -2:])
    pred = rout7 if fba.refinement else out7
    return pred[..., 0:1], pred


@torch.no_grad()
def trimap_eval_step(stm: STM, bank: MemoryBank, frame01: torch.Tensor,
                     first_trimap3: torch.Tensor, first_frame: bool, memorize: bool,
                     max_memory_num: int = 5, memorize_gt: bool = False
                     ) -> Tuple[MemoryBank, torch.Tensor]:
    """Trimap propagation alone (trimap FullModel_eval stage 1,
    models/trimap/model.py:173-281), with the stage-1 STM (hdim -1): the GT
    trimap on the first frame, else segment over the bank and softmax; then
    memorize this frame, every frame, with its predicted trimap (the GT
    one with memorize_gt) and update the bank (in place).  With
    memorize_gt an overflow evicts slot 0 instead of keeping it
    (model.py:215-221).  frame01 [B, H, W, 3] in [0, 1].  Returns (bank,
    trimap3 [B, H, W, 3])."""
    if stm.hdim > 0:
        raise ValueError("trimap_eval_step runs the stage-1 STM (hdim -1)")
    if first_frame:
        pred = first_trimap3
    else:
        logits = stm.segment(frame01, bank.keys, bank.values, bank.slot_mask)
        pred = torch.softmax(logits, dim=-1)
    mem_tri = first_trimap3 if memorize_gt else pred
    k, v = stm.memorize(frame01, mem_tri[..., 1], mem_tri[..., 2])
    bank = update_bank(bank, k, v, first_frame, memorize, max_memory_num,
                       keep_first=not memorize_gt)
    return bank, pred


def make_eval_bank(batch: int, height: int, width: int, max_memory_num: int = 5,
                   dtype=torch.float32, scale: int = 1, device=None) -> MemoryBank:
    """Bank for the /16 feature maps of a (padded) H x W frame, on CUDA
    unless `device` says otherwise."""
    if height % 16 or width % 16:
        raise ValueError(f"frame {height}x{width} is not a multiple of 16")
    return init_bank(batch, (height // 16) * (width // 16), max_memory_num, dtype,
                     key_dim=KEY_DIM // scale, val_dim=VAL_DIM // scale,
                     device=resolve_device(device))


# ---------------------------------------------------------------------------
# training forwards (stages 1-4 of train.py; train_s1_trimap.py)
# ---------------------------------------------------------------------------

def _in_dtype(module: torch.nn.Module, dtype: Optional[torch.dtype]):
    """module's call, in `dtype` where one is given: through copies of its
    floating parameters and buffers cast to it (torch.func.functional_call),
    so the network computes in `dtype` and the gradients flow through the
    casts to the fp32 masters."""
    if dtype is None:
        return module
    state = {name: t.to(dtype) if t.is_floating_point() else t
             for name, t in itertools.chain(module.named_parameters(), module.named_buffers())}
    return lambda *args, **kwargs: torch.func.functional_call(module, state, args, kwargs)


def _checkpointed(fn):
    """fn recomputed in the backward pass instead of keeping its activations.
    The training forward draws no random numbers, so the RNG state is not
    stashed for the re-run (a CUDA-graph capture of the step refuses that
    stash: train/graphs.py)."""
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def joint_train_forward(stm: STM, fba: FBA, batch: Dict[str, torch.Tensor], stage: int,
                        compute_dtype: Optional[torch.dtype] = None, remat: bool = False,
                        exact_edt: bool = False, group=None):
    """Training forward and loss of stage 1-4 (alpha FullModel.forward,
    models/alpha/model.py:189-312), on the device of the modules and batch.

    batch, NHWC with S frames a clip: fg, bg [B, S, H, W, 3] RGB in [0, 1];
    alpha [B, S, H, W, 1]; tri [B, S, H, W, 3] the one-hot GT trimap.
    Frame 0 reads the GT trimap; at stage > 1 every later frame's trimap
    is propagated: memorize the previous frame with its (refined) alpha,
    trimap and hidden state, segment over the stacked bank, softmax.
    Returns (total, aux): total = L_alpha_comp + L_lap + L_grad (+ L_tri at
    stage > 1), train.py:355-366; aux holds the four terms, alphas and comps
    [B, S, H, W, 1|3], and the trimap logits at stage > 1.

    compute_dtype=torch.bfloat16 runs the networks (and the cross-feed) in
    bf16 on casted copies of the weights; the gradients reach the fp32
    masters, and ground truth and the loss arithmetic stay fp32.
    remat=True recomputes each network call and frame loss in the backward
    pass (torch.utils.checkpoint), as the JAX package's OTVM_REMAT=1 does:
    the reads then run twice.  exact_edt: the clicks from the exact EDT.
    group: the data-parallel ranks whose rows make up the global batch
    (parallel/dist.py), for the exclusion loss's batch means; None: the
    batch is the whole batch.  The loss is this rank's rows' part: its
    mean over the ranks is the global batch's loss."""
    refinement = stage > 2
    if fba.refinement != refinement or (stm.hdim > 0) != refinement:
        raise ValueError(f"the models do not match stage {stage}")
    use_trimap_net = stage > 1
    stm_c, fba_c = _in_dtype(stm, compute_dtype), _in_dtype(fba, compute_dtype)
    ckpt = _checkpointed if remat else (lambda f: f)
    fba_call = ckpt(fba_c)
    stm_memorize = ckpt(functools.partial(stm_c, "memorize"))
    stm_segment = ckpt(lambda im, ks, vs: stm_c("segment", im, ks, vs))
    frame_loss = ckpt(functools.partial(L.fba_frame_loss, include_lap=False, group=group))

    fg, bg, gt_alpha, tri = batch["fg"], batch["bg"], batch["alpha"], batch["tri"]
    B, S = fg.shape[:2]
    img = fg * gt_alpha + bg * (1.0 - gt_alpha)
    # `img` stays fp32 for the loss; `img_c` feeds the networks
    img_c = img.to(compute_dtype) if compute_dtype is not None else img
    gt_trimask = (argmax_small(tri) == 1).float()[..., None]

    preds_trimap = [None] * S
    preds_trimap_refine = [None] * S
    logit_trimap = [None] * (S - 1)
    logit_trimap_refine = [None] * S
    outs, routs = [None] * S, [None] * S
    preds_trimap[0] = tri[:, 0].to(img_c.dtype)
    preds_trimap_refine[0] = preds_trimap[0]
    mem_k, mem_v = [], []

    for t in range(S):
        feats8, _ = make_trimap_features(preds_trimap[t], exact_edt)
        x11 = torch.cat([normalize_image(img_c[:, t]), feats8], dim=-1)
        out7, hid, rout7, rtri = fba_call(x11, img_c[:, t], feats8[..., -2:])
        outs[t], routs[t] = out7, rout7
        if refinement:
            logit_trimap_refine[t] = rtri
            if t > 0:
                preds_trimap_refine[t] = torch.softmax(rtri, dim=-1)
        if t == S - 1:
            break
        if not use_trimap_net:
            preds_trimap[t + 1] = tri[:, t + 1].to(img_c.dtype)
            continue
        if refinement:
            input_alpha, input_trimap = rout7[..., 0:1], preds_trimap_refine[t]
            kwargs = dict(alpha=input_alpha[..., 0], hidden=hid)
        else:
            input_trimap, kwargs = preds_trimap[t], {}
        k, v = stm_memorize(img_c[:, t], input_trimap[..., 1], input_trimap[..., 2], **kwargs)
        mem_k.append(k)
        mem_v.append(v)
        logit = stm_segment(img_c[:, t + 1], torch.stack(mem_k, dim=1), torch.stack(mem_v, dim=1))
        logit_trimap[t] = logit
        preds_trimap[t + 1] = torch.softmax(logit, dim=-1)

    def seq_loss(preds):
        # the loss arithmetic is fp32; the Laplacian term is left to one
        # lap_loss_diff7 over the whole sequence, both heads stacked
        terms = [frame_loss(preds[t].float(), gt_trimask[:, t], gt_alpha[:, t], fg[:, t],
                            bg[:, t], img[:, t]) for t in range(S)]
        L_ac = sum(x[0] for x in terms) / S
        L_gr = sum(x[1] for x in terms) / S
        alphas, comps, fs, bs = (torch.stack([x[i] for x in terms], dim=1) for i in (3, 4, 5, 6))
        L_gr = L_gr + L.temporal_coherence_loss(alphas, fs, bs, gt_alpha, fg, bg)
        return L_ac, L_gr, alphas, comps, fs, bs

    def diff7(alphas, fs, bs):
        d = torch.cat([alphas - gt_alpha, fs - fg, bs - bg], dim=-1)
        return d.reshape((B * S,) + tuple(d.shape[2:]))

    L1 = seq_loss(outs)
    if refinement:
        L2 = seq_loss(routs)
        L_alpha_comp, L_grad = L1[0] + L2[0], L1[1] + L2[1]
        # the heads are summed, so the stacked 2*B*S diff normalizes by B*S
        lap_in = torch.cat([diff7(L1[2], L1[4], L1[5]), diff7(L2[2], L2[4], L2[5])], dim=0)
        alphas, comps = L2[2], L2[3]
    else:
        L_alpha_comp, L_grad = L1[0], L1[1]
        lap_in = diff7(L1[2], L1[4], L1[5])
        alphas, comps = L1[2], L1[3]
    L_lap = ckpt(L.lap_loss_diff7)(lap_in, B * S)

    aux = dict(alphas=alphas, comps=comps)
    if use_trimap_net:
        aux["logit_trimap"] = torch.stack(logit_trimap, dim=1)
        loss_trimap = L.cross_entropy(aux["logit_trimap"].float(), argmax_small(tri[:, 1:]))
        if refinement:
            aux["logit_trimap_refine"] = torch.stack(logit_trimap_refine, dim=1)
            loss_trimap = loss_trimap + L.cross_entropy(aux["logit_trimap_refine"].float(),
                                                        argmax_small(tri))
    else:
        loss_trimap = torch.zeros((), device=fg.device)

    total = L_alpha_comp + L_lap + L_grad
    if stage > 1:
        total = total + loss_trimap
    aux.update(L_alpha_comp=L_alpha_comp, L_lap=L_lap, L_grad=L_grad, L_tri=loss_trimap)
    return total, aux


def trimap_train_forward(stm: STM, batch: Dict[str, torch.Tensor], ignore_label: int = 255,
                         compute_dtype: Optional[torch.dtype] = None):
    """Stage-1 trimap training forward (trimap FullModel._forward,
    models/trimap/model.py:75-131), batched.  batch: img [B, S, H, W, 3] in
    [0, 1], tri [B, S, H, W, 3] one-hot.  Frame t is segmented over the
    memories of frames 0..t-1, each memorized with the trimap of its own
    frame (GT at frame 0, propagated after).  Returns (loss, {'pred':
    [B, S, H, W, 3]}): the CE of frames 1.. (fp32), averaged."""
    if stm.hdim > 0:
        raise ValueError("trimap training is the stage-1 STM (hdim -1)")
    stm_c = _in_dtype(stm, compute_dtype)
    img, tri = batch["img"], batch["tri"]
    if compute_dtype is not None:
        img, tri = img.to(compute_dtype), tri.to(compute_dtype)
    S = img.shape[1]
    preds = [tri[:, 0]]
    logits, mem_k, mem_v = [], [], []
    for t in range(1, S):
        k, v = stm_c("memorize", img[:, t - 1], preds[t - 1][..., 1], preds[t - 1][..., 2])
        mem_k.append(k)
        mem_v.append(v)
        logits.append(stm_c("segment", img[:, t], torch.stack(mem_k, dim=1),
                            torch.stack(mem_v, dim=1)))
        preds.append(torch.softmax(logits[-1], dim=-1))
    gt = argmax_small(tri)
    loss = sum(L.cross_entropy(logits[t - 1].float(), gt[:, t], ignore_label)
               for t in range(1, S)) / float(S - 1)
    return loss, dict(pred=torch.stack(preds, dim=1))
