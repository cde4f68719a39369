"""How long a collective takes among ranks that share a card.

    python3 tools/collective_latency.py [--world 4] [--iters 100]

On a machine with a CUDA card: ``--world`` ranks spawned by
``repro_torch.launch.mesh.run_ranks`` on the card (gloo, every
collective staged through the host, as ``chip_smoke.py`` phases 5b-5d
run them), on a (model = world) mesh.  For host tensors of the sizes a
decode pass exchanges (a (8, 2560) bf16 and f32 residual-stream partial
sum, and 1.2 MB of f32 logits), it times gloo's ``all_reduce``, its
``all_gather_into_tensor`` alone and followed by the sum of the parts
(what ``collectives.psum`` does below ``GATHER_SUM_BYTES`` on a
host-staged mesh), and ``collectives.psum`` of the card tensor, the
copies to and from the host included; then a ``barrier``.  Each rank
runs once with one torch thread (``run_ranks``' setting) and once with
one a CPU core.  Then, with one thread: the same host ``all_reduce``
and ``all_gather_into_tensor`` plus sum at 1.5, 2, 4, 8, 21 and 84 MB
of f32, ``--iters`` // 10 calls each (where the two paths cross); and
on a (data 2, model 2) mesh, one full-width qwen1.5-4b layer's
parameters in bf16 gathered for a decode step
(``serve.decode``'s FSDP gather over ``data``) leaf by leaf by
``sharding.gather_for_use``, as serving does, and in one buffer an axis
(``_batched_gather``).  Prints one JSON line a setting:
milliseconds a call, the mean over its calls of rank 0.  Imports no
jax."""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SIZES = (("40KB_bf16", 8 * 2560, "bfloat16"), ("80KB_f32", 8 * 2560,
                                              "float32"),
         ("1.2MB_f32", 8 * 37984, "float32"))
LARGE = tuple((f"{mb}MB_f32", int(mb * (1 << 20)) // 4, "float32")
              for mb in (1.5, 2, 4, 8, 21, 84))


def _clock(fn, iters):
    import torch
    import torch.distributed as dist
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def _host_sums(res, sizes, ax, world, iters, card):
    """Time the host collectives (and with ``card`` the card's psum) at
    ``sizes`` into ``res``."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives as col
    for name, n, dname in sizes:
        dt = getattr(torch, dname)
        x = torch.randn(n, dtype=dt)
        out = torch.empty(world * n, dtype=dt)
        res["all_reduce_" + name] = _clock(
            lambda: dist.all_reduce(x.clone(), group=ax.group), iters)
        res["all_gather_sum_" + name] = _clock(
            lambda: (dist.all_gather_into_tensor(out, x, group=ax.group),
                     out.view(world, n).sum(dim=0)), iters)
        if card:
            res["all_gather_" + name] = _clock(
                lambda: dist.all_gather_into_tensor(out, x, group=ax.group),
                iters)
            xc = x.to("cuda")
            res["psum_card_" + name] = _clock(lambda: col.psum(xc, ax),
                                              iters)


def _rank(rank, out_dir, threads, iters):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(threads)
    world = dist.get_world_size()
    mesh = make_host_mesh(device="cuda", model=world)
    ax = mesh.axis("model")
    res = {"threads": torch.get_num_threads()}
    _host_sums(res, SIZES, ax, world, iters, True)
    res["barrier"] = _clock(dist.barrier, iters)
    if rank == 0:
        print(json.dumps(res), flush=True)
    if threads != 1:
        return
    res = {"threads": 1}
    _host_sums(res, LARGE, ax, world, max(1, iters // 10), False)
    if rank == 0:
        print(json.dumps(res), flush=True)
    if world == 4:
        _layer_gather(iters)


def _batched_gather(xs, specs, mesh, keeps):
    """``gather_for_use`` of every leaf of ``xs`` with one all-gather a
    mesh axis and type for all of them, each rank's blocks flattened into
    one buffer: the alternative measured against the leaf-by-leaf
    gather that serving takes."""
    import torch
    from repro_torch.dist import collectives as col
    from repro_torch.dist import sharding as shd
    out = list(xs)
    for a in reversed(mesh.axis_names):
        if mesh.shape[a] == 1:
            continue
        todo = {}
        for i, (spec, keep) in enumerate(zip(specs, keeps)):
            dims = [d for d, e in enumerate(spec)
                    if a in shd.entry_axes(e)]
            if dims and a not in keep:
                todo.setdefault(out[i].dtype, []).append((i, dims[0]))
        for group in todo.values():
            flat = torch.cat([out[i].reshape(-1) for i, _ in group])
            parts = col.all_gather(flat, mesh.axis(a), 0)
            at = 0
            for i, dim in group:
                n, shape = out[i].numel(), out[i].shape
                out[i] = torch.cat([q[at:at + n].view(shape)
                                    for q in parts], dim)
                at += n
    return out


def _layer_gather(iters):
    """Time one decode layer's parameter gather on (data 2, model 2),
    leaf by leaf (``serve.decode``'s) and batched."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.serve import decode, engine

    mesh = make_host_mesh(device="cuda", data=2, model=2)
    cfg = get_config("qwen1.5-4b").replace(n_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = engine._place(lm.init_model(cfg, gen), cfg, mesh)
    torch.cuda.empty_cache()
    meta = decode.init_caches(cfg, 8, 256, "meta")
    specs = shd.decode_cache_shardings(cfg, meta, mesh)
    om = decode._OnMesh(cfg, mesh, meta, specs)
    # the leaves, specs and kept axes of one layer's gather
    leaves, plain = [], shd.gather_for_use
    shd.gather_for_use = lambda x, s, m, keep=(): (
        leaves.append((x, s, tuple(keep))), plain(x, s, m, keep))[1]
    try:
        om.layer(params, "layers", 0, 0)
    finally:
        shd.gather_for_use = plain
    xs, sp, keeps = zip(*leaves)
    n = max(1, iters // 10)
    res = {"mesh": repr(mesh), "layer": cfg.name, "leaves": len(xs)}
    res["per_leaf_layer_gather"] = _clock(
        lambda: [plain(x, s, mesh, k) for x, s, k in leaves], n)
    res["batched_layer_gather"] = _clock(
        lambda: _batched_gather(xs, sp, mesh, keeps), n)
    res["per_leaf_layer_gather_again"] = _clock(
        lambda: [plain(x, s, mesh, k) for x, s, k in leaves], n)
    if mesh.rank == 0:
        print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("collective_latency: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import run_ranks
    print(torch.cuda.get_device_name(0), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for threads in (1, os.cpu_count()):
        d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        run_ranks(_rank, args.world, d, threads, args.iters,
                  init_method=f"file://{d}/pg", device="cuda",
                  timeout_s=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
