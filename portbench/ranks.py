"""One process per rank for the cells on several chips: `spawn` starts
`world` processes (spawn start method), each with its CUDA device (or the
CPU and gloo, in the tests) and a process group over localhost, runs
`target(rank, world, *args)` in each, and waits for all of them. The
exit codes come back through a queue; a rank that dies ends the wait.
Besides the process group of the program (NCCL on the cards), each rank
joins a gloo group, `HOST`, that the harness's own exchanges between the
ranks use (`host_reduce`, `host_gather`): they run on the host, so no
kernel of the harness's reaches a card or its trace."""
import multiprocessing as mp
import queue
import socket
import sys
import time

HOST = None     # the ranks' gloo group, set in each rank's process


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _child(target, rank, world, port, device, args, codes):
    import torch
    import torch.distributed as dist
    code = 1
    try:
        dev = torch.device(device or f'cuda:{rank}')
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        dist.init_process_group(
            'nccl' if dev.type == 'cuda' else 'gloo',
            init_method=f'tcp://localhost:{port}', world_size=world,
            rank=rank)
        global HOST
        HOST = dist.new_group(backend='gloo')
        try:
            code = target(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
    finally:
        sys.stdout.flush()
        codes.put((rank, code))


def host_reduce(op, value):
    """`value` reduced over the ranks by 'sum' or 'max', on the host."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == 'sum'
                    else dist.ReduceOp.MAX, group=HOST)
    return float(t.item())


def host_gather(obj):
    """Every rank's `obj` (picklable), by rank, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=HOST)
    return out


def spawn(target, world, args=(), device=None, timeout=3000):
    """Run `target(rank, world, device, *args)` in `world` processes;
    returns their exit codes by rank (1 for a rank that never reported)."""
    ctx = mp.get_context('spawn')
    codes = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(target, r, world, port, device,
                                              args, codes))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.time() + timeout
    while len(got) < world and time.time() < deadline:
        try:
            rank, code = codes.get(timeout=5)
            got[rank] = code
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join()
    codes.close()
    return [got.get(r, 1) for r in range(world)]
