"""Multi-process (multi-host) search across the data-center network — runnable
sketch.

The sharded device programs (`vector_db_tpu/parallel/sharded.py`) are pure
`shard_map` array programs: under a multi-process JAX runtime they compile
and run unchanged, with XLA handing the top-k merge collectives to NCCL
(NVLink within a host, the network across hosts).  What IS single-controller
today is the `ShardedDatabase` host wrapper (its numpy mirrors assume one
writer process) — see docs/SCALING.md §3 for the exact boundary.

This example is the multi-process recipe:

  one process per host, all hosts see one global mesh:

    # host 0                                      # host i
    python examples/multiprocess_dcn.py \
        --coordinator host0:8476 --num-processes 4 --process-id 0   # ... i

  each process generates/loads ONLY its local shard of the corpus and
  assembles the globally-sharded array with
  jax.make_array_from_process_local_data; the jitted shard_map search then
  runs SPMD across every device of every process.

Run with no arguments for the single-process fallback (all local devices,
same code path) — that is also what the CPU test drives with 8 virtual
devices.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="",
                    help="host:port of process 0 (enables multi-process)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--per-shard", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=64)
    args = ap.parse_args(argv)

    import jax

    if args.coordinator:
        # the one line that turns N single-host runtimes into one global
        # runtime: after this, jax.devices() spans every host and pjit/
        # shard_map programs are SPMD across all of them (network between
        # hosts)
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vector_db_tpu.parallel import sharded as sh

    n_dev = len(jax.devices())
    mesh = sh.make_mesh(n_dev)
    k, nq = 10, 64
    per_dev = args.per_shard
    n_total = per_dev * n_dev

    # ---- per-process local corpus shard ----------------------------------
    # each process materialises ONLY the rows for its own devices (at real
    # scale: read your shard of the dataset here instead of generating)
    local_dev = jax.local_devices()
    rows = []
    for d in local_dev:
        # device id == global shard index on a 1-D mesh
        rng = np.random.default_rng(42 + d.id)
        rows.append(rng.standard_normal((per_dev, args.dim)).astype(np.float32))
    local = np.concatenate(rows)
    sharding = NamedSharding(mesh, P(sh.AXIS, None))
    vectors = jax.make_array_from_process_local_data(sharding, local,
                                                     (n_total, args.dim))
    norms = jnp.sum(vectors * vectors, axis=1)  # sharded elementwise, no comm
    valid = jnp.ones((n_total,), bool)
    valid = jax.device_put(valid, NamedSharding(mesh, P(sh.AXIS)))

    # ---- replicated queries + the corpus-sharded search ------------------
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((nq, args.dim)).astype(np.float32)
    fn = sh.sharded_knn(mesh, k)
    d, idx = fn(jnp.asarray(queries), vectors, valid, norms)
    d, idx = np.asarray(d), np.asarray(idx)

    if jax.process_index() == 0:
        print(f"processes={jax.process_count()} devices={n_dev} "
              f"corpus={n_total:,}x{args.dim}")
        print("top-3 global slots for query 0:", idx[0, :3].tolist(),
              "dists:", np.round(d[0, :3], 4).tolist())
        # self-check in the generated-data setup: re-derive row 0 of shard 0
        rng0 = np.random.default_rng(42)
        v0 = rng0.standard_normal((per_dev, args.dim)).astype(np.float32)
        dd = ((queries[:1] - v0) ** 2).sum(1)
        print("local brute check (shard 0 only):", int(dd.argmin()))
    return d, idx


if __name__ == "__main__":
    main()
