"""Rank functions of tests/test_torch_ddp.py, run by parallel/dist.py spawn
in fresh processes: a module of their own, so that a rank imports torch and
the port but not JAX, which the test module imports."""
import os

import numpy as np
import torch

from otvm_tpu_torch.parallel import dist as D


def local_exclusion_rank(*args):
    """tools/ddp_check.py's rank with the exclusion loss's batch means taken
    over this rank's rows alone (the mutation the comparison must catch)."""
    from otvm_tpu_torch.tools import ddp_check
    from otvm_tpu_torch.train import losses

    losses.batch_means = lambda tensors, group=None: [t.mean() for t in tensors]
    return ddp_check._rank_main(*args)


def resumed_step_rank(cfg, ckpt_path: str, batch_path: str, out_path: str):
    """Restores a 1-process checkpoint into this rank's state, takes one
    step on its rows of the global batch in `batch_path`, and rank 0 saves
    the state to `out_path`.  First, inits from seeds that differ by rank
    must be refused.  -> (the ranks' mean loss, the refusal's message)."""
    from otvm_tpu_torch.train import trainer as T
    from otvm_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

    device = D.init_distributed("cpu")
    group, rank, world = D.data_group(), D.process_index(), D.process_count()
    try:
        T.init_train_state(cfg, seed=rank, device=device, group=group)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    state = restore_train_state(ckpt_path, T.init_train_state(cfg, device=device, group=group))
    batch = dict(np.load(batch_path))
    b = len(batch["fg"]) // world
    state, metrics = T.make_train_step(cfg)(state, {k: v[rank * b:(rank + 1) * b]
                                                    for k, v in batch.items()})
    if rank == 0:
        save_train_state(out_path, state)
    return D.all_reduce_mean([metrics["loss"]], group)[0].item(), refused


def cli_rank(cwd: str, data_root: str, scale: int, argvs):
    """Each of `argvs` ((module name, argv) of the training CLIs) run with
    main(argv) in working directory `cwd`, the models at `scale`; records
    each run's Loader indices and batch size, each step's batch and this
    rank's loss.  -> [(main's result without the state, the records)]."""
    from otvm_tpu_torch.cli import train as cli_train
    from otvm_tpu_torch.cli import train_s1_trimap as cli_s1
    from otvm_tpu_torch.config import get_cfg_defaults

    def scaled():
        cfg = get_cfg_defaults()
        cfg.model_scale = scale
        return cfg

    os.chdir(cwd)
    out = []
    loader = cli_train.Loader       # both CLIs' epochs: cli/train.py's epoch_loader
    for name, argv in argvs:
        cli = {"train": cli_train, "train_s1_trimap": cli_s1}[name]
        log = dict(loaders=[], batches=[], losses=[])
        make_step = cli.make_trimap_s1_train_step if cli is cli_s1 else cli.make_train_step

        def recording_loader(dataset, idx, batch_size, **kwargs):
            log["loaders"].append((np.asarray(idx).tolist(), batch_size))
            return loader(dataset, idx, batch_size, **kwargs)

        def recording_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def run(state, batch):
                log["batches"].append({k: np.array(v) for k, v in batch.items()})
                state, metrics = step(state, batch)
                log["losses"].append(metrics["loss"].item())
                return state, metrics

            return run

        cli.get_cfg_defaults, cli_train.Loader = scaled, recording_loader
        if cli is cli_s1:
            cli.make_trimap_s1_train_step = recording_step
        else:
            cli.make_train_step = recording_step
        result = cli.main(argv)
        result["step"] = result.pop("state").step
        out.append((result, log))
        torch.distributed.barrier()
    return out


def collectives_rank():
    """parallel/dist.py's collectives on 2 CPU ranks, each with its own
    values: -> what each gives on this rank."""
    D.init_distributed("cpu")
    group, rank = D.data_group(), D.process_index()
    x = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)          # rank 0: 1, 2, 3; rank 1: 2, 4, 6
    leaf = x.clone().requires_grad_()
    (mean,) = D.batch_means([leaf], group)                  # (1+2+3+2+4+6) / 6 = 3
    (mean * (rank + 1)).backward()                          # the ranks' losses: 1x and 2x
    p, q = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    r = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 2.0 * (rank + 1))             # both ranks: mean 3
    if rank == 0:
        q.grad = torch.full((2,), 4.0)                      # rank 1 lacks it: mean 2
    D.all_reduce_gradients([p, q, r], group, bucket_bytes=8)
    return dict(mean=mean.item(), grad=leaf.grad.tolist(), p=p.grad.tolist(), q=q.grad.tolist(),
                r=r.grad, rows=D.all_gather_rows(x, group).tolist(),
                mean_of=D.all_reduce_mean([x], group)[0].tolist(),
                equal_x=D.ranks_equal([x], group), equal_ones=D.ranks_equal([p.detach()], group))


def _all_reduce_gradients_unplanned(params, group, bucket_bytes):
    """parallel/dist.py's all_reduce_gradients as it was before its plan and
    device part were split (the mask read on the host in the same call):
    the reference that the two parts must equal bit for bit."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    held = torch.tensor([float(p.grad is not None) for p in params])
    dist.all_reduce(held, group=group)
    for p, n in zip(params, held.tolist()):
        if n and p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params if p.grad is not None]
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i == len(grads) - 1
        if last or size >= bucket_bytes or grads[i + 1].dtype != g.dtype:
            flat = torch.cat([x.reshape(-1) for x in bucket])
            dist.all_reduce(flat, group=group)
            flat /= world
            for x, piece in zip(bucket, flat.split([x.numel() for x in bucket])):
                x.copy_(piece.view_as(x))
            bucket, size = [], 0


def _params(rank, step):
    """Parameters with seeded gradients that differ by rank and step:
    parameter 2 has none on rank 1, parameter 4 none on any rank, and the
    fp64 parameter 5 starts a bucket of its own."""
    gen = torch.Generator().manual_seed(100 * step + rank)
    shapes = [(3, 4), (5,), (2, 2), (7,), (4,), (3,), (6,)]
    params = [torch.nn.Parameter(torch.ones(s, dtype=torch.float64 if i == 5 else torch.float32))
              for i, s in enumerate(shapes)]
    for i, p in enumerate(params):
        if not (i == 4 or (i == 2 and rank == 1)):
            p.grad = torch.randn(p.shape, generator=gen, dtype=p.dtype) / 3
    return params


def gradient_plan_rank():
    """The gradient plan (parallel/dist.py) on 2 CPU ranks: -> per check,
    what this rank saw."""
    D.init_distributed("cpu")
    group, rank = D.data_group(), D.process_index()
    bits = lambda ps: [None if p.grad is None else p.grad.view(-1).tolist() for p in ps]
    out = {}
    # the two parts (and all_reduce_gradients, made of them) against the
    # unsplit function, over 3 steps of other gradients
    same = []
    for step in range(3):
        want, got, planned = _params(rank, step), _params(rank, step), _params(rank, step)
        _all_reduce_gradients_unplanned(want, group, 40)
        D.all_reduce_gradients(got, group, bucket_bytes=40)
        plan = D.plan_gradients(planned, group, bucket_bytes=40)
        D.reduce_gradients(plan, planned)
        same.append(bits(want) == bits(got) == bits(planned))
    out.update(same=same, held=plan.held, buckets=plan.buckets, world=plan.world,
               none=[p.grad is None for p in planned], grad=bits(planned))
    # one plan a key, made by the key's first call and reused
    plans, made = D.GradientPlans(bucket_bytes=40), []
    make = D.plan_gradients
    D.plan_gradients = lambda *a, **k: made.append(1) or make(*a, **k)
    try:
        firsts, planned_same = [], []
        for step in range(3):
            params, want = _params(rank, step), _params(rank, step)
            firsts.append(plans("key", params, group))
            _all_reduce_gradients_unplanned(want, group, 40)
            planned_same.append(bits(params) == bits(want))
        out.update(made=len(made), reused=all(p is firsts[0] for p in firsts),
                   planned_same=planned_same)
        # a step that contradicts the plan: a gradient that no rank held
        params = _params(rank, 3)
        params[4].grad = torch.ones(4)
        try:
            plans("key", params, group)
            out["contradiction"] = None
        except RuntimeError as e:
            out["contradiction"] = str(e)
    finally:
        D.plan_gradients = make
    # the keys of the ranks' steps: equal ones pass, different ones raise
    D.check_same_key(("joint", 4, (("fg", (2, 3)),)), group, torch.device("cpu"))
    try:
        D.check_same_key(("joint", 4, (("fg", (2 + rank, 3)),)), group, torch.device("cpu"))
        out["keys"] = None
    except RuntimeError as e:
        out["keys"] = str(e)
    return out
