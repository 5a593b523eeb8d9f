"""Two-process multi-host simulation of the sharded ILS codec.

Validates BASELINE config 5's logic (cross-host data-parallel decode with a
replicated table and ordered gather) without a multi-host cluster: two OS
processes, each owning 4 virtual CPU devices, join one `jax.distributed`
cluster; the global 8-device mesh shards tiles across both processes and
the final equality check is a cross-host `pmin`.

Run:  python tools/multihost_sim.py
(spawns the two workers itself; exits 0 on bit-exact success)
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = int(os.environ.get("MULTIHOST_SIM_PORT", "45701"))
N_PROC = 2
DEV_PER_PROC = 4


def worker(pid: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=N_PROC,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp

    from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
    from huffman_jax.core.canonical import chain_spec
    from huffman_jax.core.ils_ref import ils_schedule_numer
    from huffman_jax.ops.ils import as_u32_rows
    from huffman_jax.ops.ils_xla import ils_dec_tabs, ils_enc_tabs
    from huffman_jax.parallel import data_mesh, make_ils_sharded_roundtrip
    from huffman_jax.utils import generate_redundant

    n_devices = jax.device_count()
    assert n_devices == N_PROC * DEV_PER_PROC, n_devices
    assert jax.process_count() == N_PROC

    k, tpd = 8, 2
    n = n_devices * tpd * k * 1024
    data = generate_redundant(n, 0.5, seed=0)  # same on every process
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)

    mesh = data_mesh(n_devices)
    step = make_ils_sharded_roundtrip(
        mesh,
        k=k,
        max_len=max(table.max_len_present, 1),
        min_len=table.min_len,
        chain=chain_spec(table),
        tiles_per_device=tpd,
    )
    # build the globally-sharded input from per-process local shards
    global_shape = (n_devices, tpd * (k // 4), 1024)
    full = as_u32_rows(data).reshape(global_shape)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", None, None)
    )
    mesh_order = list(mesh.devices.flat)
    arrays = [
        jax.device_put(full[i : i + 1], device=d)
        for i, d in enumerate(mesh_order)
        if d.process_index == pid
    ]
    data_dev = jax.make_array_from_single_device_arrays(
        global_shape, sharding, arrays
    )
    avg = float((freqs * table.lengths.astype(np.int64)).sum() / data.size)
    out, ok = step(data_dev, jnp.int32(ils_schedule_numer(avg)),
                   ils_enc_tabs(table), ils_dec_tabs(table))
    ok = int(ok)  # replicated scalar, addressable everywhere
    # verify this process's local output shards against the original
    dev_pos = {d: i for i, d in enumerate(mesh_order)}
    for shard in out.addressable_shards:
        i = dev_pos[shard.device]
        got = np.asarray(shard.data).reshape(-1, 1024)
        want = full[i]
        assert np.array_equal(got, want), f"shard {i} mismatch"
    assert ok == 1, "cross-host pmin verification failed"
    print(f"process {pid}: OK ({len(arrays)} local devices)", flush=True)


def main() -> int:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, f"--worker={p}"], env=env
        )
        for p in range(N_PROC)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    print("multihost_sim:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    for a in sys.argv[1:]:
        if a.startswith("--worker="):
            worker(int(a.split("=")[1]))
            sys.exit(0)
    sys.exit(main())
