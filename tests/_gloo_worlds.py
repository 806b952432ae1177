"""Gloo worlds for the port's multi-rank CPU tests: ``spawn_worlds`` runs a
job on a world of each given size, every rank a spawned process, and
``local_world`` on an in-process world of one. The module imports no JAX,
so a spawned rank loads only torch and the job's own module."""
import datetime
import importlib
import multiprocessing as mp
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

JOIN_S = 180


def _world_main(rank, n, store_path, out_path, job_module, job_name,
                payload_path):
    """One rank of a spawned gloo world: run ``job(rank, n, group,
    payload)``; rank 0 saves what it returns."""
    torch.set_num_threads(1)          # the worlds share the machine's cores
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        job = getattr(importlib.import_module(job_module), job_name)
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)          # written by spawn_worlds
        out = job(rank, n, dist.group.WORLD, payload)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def spawn_worlds(sizes, tmp_dir, job, payload):
    """Run ``job`` on a gloo world of each size in ``sizes``, every rank a
    spawned process, the worlds side by side; {size: rank 0's result (a
    dict of arrays)}. The payload goes through a file: a large one through
    the start pipe would hold each start until the rank before it has
    imported its modules."""
    ctx = mp.get_context("spawn")
    payload_path = os.path.join(tmp_dir, "payload.pkl")
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    procs, outs = [], {}
    for n in sizes:
        store = os.path.join(tmp_dir, f"store{n}")
        outs[n] = os.path.join(tmp_dir, f"out{n}.npz")
        procs += [ctx.Process(target=_world_main,
                              args=(r, n, store, outs[n], job.__module__,
                                    job.__name__, payload_path))
                  for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
            assert not p.is_alive(), "a rank did not finish in time"
            assert p.exitcode == 0, f"a rank exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    got = {}
    for n, out in outs.items():
        with np.load(out) as f:
            got[n] = {k: f[k] for k in f.files}
    return got


def local_world(job, payload):
    """Run ``job`` on an in-process gloo world of 1."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        return job(0, 1, dist.group.WORLD, payload)
    finally:
        dist.destroy_process_group()
