"""Quickstart on the PyTorch/CUDA port: MIND's in-network MMU in a minute.

The counterpart of ``examples/quickstart.py``: allocate through the control
plane, access through the switch data plane (translation -> protection ->
MSI coherence), watch Bounded Splitting adapt directory granularity, run
the same lookups on the port's TCAM kernels, then replay one trace on the
scalar oracle and the batched engine (the CUDA stage-3 kernel on the card)
and check that they agree.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.convert import tables_to_device  # noqa: E402
from repro_torch.core import AccessType, MemAccess, Perm  # noqa: E402
from repro_torch.core import traces as T  # noqa: E402
from repro_torch.core.control_plane import ControlPlane  # noqa: E402
from repro_torch.core.emulator import DisaggregatedRack  # noqa: E402
from repro_torch.core.switch import make_mmu  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cuda unless 'cpu')")
    ap.add_argument("--accesses", type=int, default=3000,
                    help="hot-region accesses for Bounded Splitting")
    ap.add_argument("--replay", type=int, default=250,
                    help="accesses per thread of the replayed trace")
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_quickstart", "--device cpu")

    # --- a rack: 4 memory blades, 4 compute blades, one switch --------
    mmu, allocator = make_mmu(num_memory_blades=4, num_compute_blades=4,
                              cache_bytes_per_blade=1 << 20)
    cp = ControlPlane(mmu, allocator, epoch_us=1_000.0)
    vma_a = cp.sys_mmap(pdid=1, length=256 << 10, requesting_blade=0).vma
    vma_b = cp.sys_mmap(pdid=2, length=64 << 10, requesting_blade=1).vma
    print(f"vma A: base={vma_a.base:#x} len={vma_a.length} "
          f"blade={vma_a.blade_id}")
    print(f"vma B: base={vma_b.base:#x} len={vma_b.length} "
          f"blade={vma_b.blade_id}")

    # --- the coherence protocol ---------------------------------------
    r1 = mmu.handle(MemAccess(0, 1, vma_a.base, AccessType.WRITE))
    r2 = mmu.handle(MemAccess(2, 1, vma_a.base, AccessType.READ))
    r3 = mmu.handle(MemAccess(3, 1, vma_a.base, AccessType.WRITE))
    print(f"owner write : local={r1.acts.hit_local} "
          f"({r1.latency.total_us:.1f}us)")
    print(f"remote read : fetch_from_owner={r2.acts.fetch_from_owner} "
          f"({r2.latency.total_us:.1f}us)")
    print(f"remote write: invalidated={bin(r3.acts.invalidate)} "
          f"({r3.latency.total_us:.1f}us)")
    r4 = mmu.handle(MemAccess(1, 2, vma_a.base, AccessType.READ))
    print(f"cross-domain read -> fault={r4.acts.fault!r}")

    # --- the same lookups on the port's TCAM kernels -------------------
    tables = mmu.export_dataplane_tables()
    translate, protect = tables_to_device(tables["translate"],
                                          tables["protect"], dev)
    vaddrs = torch.tensor([vma_a.base, vma_b.base, vma_b.base + 4096],
                          dtype=torch.int64, device=dev)
    blades, _ = K.translate_lookup(vaddrs, translate)
    print(f"kernel translate -> memory blades {blades.tolist()}")
    allow = K.protect_check(
        torch.tensor([1, 2, 2], dtype=torch.int32, device=dev),
        torch.tensor([vma_a.base, vma_a.base, vma_b.base],
                     dtype=torch.int64, device=dev),
        torch.full((3,), int(Perm.READ), dtype=torch.int32, device=dev),
        protect)
    print(f"kernel protect   -> allow={allow.tolist()}  "
          f"(pdid2 on vmaA denied)")
    assert allow.tolist() == [True, False, True]

    # --- bounded splitting under a hot region --------------------------
    rng = np.random.default_rng(0)
    for i in range(args.accesses):
        blade = int(rng.integers(0, 4))
        addr = vma_a.base + int(rng.integers(0, 16)) * 4096  # 16 hot pages
        op = AccessType.WRITE if rng.random() < 0.5 else AccessType.READ
        mmu.handle(MemAccess(blade, 1, addr, op))
        if i % 500 == 499:
            rep = cp.splitting.run_epoch()
            print(f"epoch {rep.epoch}: dir={rep.directory_entries} "
                  f"splits={rep.splits} merges={rep.merges} "
                  f"t={rep.threshold:.1f}")

    # --- the batched engine against the scalar oracle ------------------
    trace = T.ycsb_trace("zipf", num_threads=4, read_ratio=0.5,
                         accesses_per_thread=args.replay, store_mb=4)
    kw = dict(num_compute_blades=2, threads_per_blade=2,
              splitting_enabled=False)
    scalar = DisaggregatedRack(system="mind", engine="scalar", **kw).run(trace)
    batched = DisaggregatedRack(system="mind", engine="batched",
                                engine_options={"device": str(dev)},
                                **kw).run(trace)
    print(f"scalar  engine: {scalar.stats.local_hits} hits, "
          f"{scalar.stats.invalidations} invalidations, "
          f"runtime {scalar.runtime_us:.0f}us")
    print(f"batched engine: {batched.stats.local_hits} hits, "
          f"{batched.stats.invalidations} invalidations, "
          f"runtime {batched.runtime_us:.0f}us  (on {dev})")
    assert scalar.stats == batched.stats
    assert scalar.runtime_us == batched.runtime_us
    print("done — see examples/torch_train_lm.py and "
          "examples/torch_serve_paged.py next")


if __name__ == "__main__":
    main()
