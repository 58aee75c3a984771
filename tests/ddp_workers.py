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
    for name, argv in argvs:
        cli = {"train": cli_train, "train_s1_trimap": cli_s1}[name]
        log = dict(loaders=[], batches=[], losses=[])
        loader, make_step = cli.Loader, cli.make_trimap_s1_train_step if cli is cli_s1 \
            else cli.make_train_step

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

        cli.get_cfg_defaults, cli.Loader = scaled, recording_loader
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
