#!/usr/bin/env python3
"""Which of gloo's collectives take CUDA tensors as they are: two gloo
ranks on the first card (``repro_torch.parallel.launch.spawn_ranks``)
each try every collective the rank mesh uses, and a few more, once on a
small tensor of the card. Prints the card, the torch version and one
JSON line of outcomes per rank.

    python3 scripts/probe_gloo_cuda.py

The port does not depend on the answer: a gloo mesh whose ranks hold CUDA
tensors stages every collective through host buffers.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


def _probe(mesh) -> dict:
    """Which of gloo's collectives take CUDA tensors as they are, on this
    torch: each tried once on a small tensor of the mesh's card, its
    outcome recorded ("accepted" with the result right, or the error's
    first line). The staging rule of ``parallel.collectives`` does not
    read it."""
    import torch.distributed as dist

    from repro_torch.parallel.collectives import _peer

    P, p, dev = mesh.size, mesh.rank, mesh.device
    mine = torch.full((2,), float(p + 1), device=dev)
    want_gather = [float(r + 1) for r in range(P) for _ in range(2)]

    def gather_into():
        out = torch.empty(2 * P, device=dev)
        dist.all_gather_into_tensor(out, mine, group=mesh.group)
        return out.tolist() == want_gather

    def gather_list():
        outs = [torch.empty(2, device=dev) for _ in range(P)]
        dist.all_gather(outs, mine, group=mesh.group)
        return torch.cat(outs).tolist() == want_gather

    def reduce():
        t = mine.clone()
        dist.all_reduce(t, group=mesh.group)
        return t.tolist() == [P * (P + 1) / 2] * 2

    def bcast():
        t = mine.clone()
        dist.broadcast(t, _peer(mesh, 0), group=mesh.group)
        return t.tolist() == [1.0, 1.0]

    def p2p():
        got = torch.empty(2, device=dev)
        ops = [dist.P2POp(dist.isend, mine, _peer(mesh, (p + 1) % P),
                          mesh.group),
               dist.P2POp(dist.irecv, got, _peer(mesh, (p - 1) % P),
                          mesh.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got.tolist() == [float((p - 1) % P + 1)] * 2

    out = {}
    for name, fn in (("all_gather_into_tensor", gather_into),
                     ("all_gather", gather_list), ("all_reduce", reduce),
                     ("broadcast", bcast), ("batch_isend_irecv", p2p)):
        try:
            out[name] = "accepted" if fn() else "accepted, wrong result"
        except Exception as e:           # the outcome is what is probed
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        torch.cuda.synchronize(dev)
    return out


def main() -> int:
    from repro_torch.parallel.launch import spawn_ranks

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"card: {card[0]}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    for rank, got in enumerate(spawn_ranks(_probe, 2, backend="gloo",
                                           device="cuda:0", timeout=120)):
        print(json.dumps({"rank": rank, **got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
