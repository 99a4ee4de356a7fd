"""Out-of-core k-means on the PyTorch/CUDA port (twin of
examples/kmeans_ooc.py).

    PYTHONPATH=src python examples/torch_kmeans_ooc.py            # host RAM
    PYTHONPATH=src python examples/torch_kmeans_ooc.py --disk     # disk tier
    PYTHONPATH=src python examples/torch_kmeans_ooc.py --device cpu --n 200000

The paper's MixGaussian-1B experiment in miniature: a mixture-of-Gaussians
dataset on the slow tier is clustered without ever holding it whole on the
card.  Each Lloyd iteration is one fused streaming pass (distances →
argmin → groupby sinks; on a card the ``kmeans_assign`` kernel, a launch a
partition), and the plan is reused across iterations (plan cache).

``--disk`` runs the FlashR external-memory workflow: the dataset is written
to the ``.fmat`` format partition by partition (it never exists whole in
RAM), reopened by name through the registry as an ``MmapStore``, and
streamed through the prefetcher (pinned host slots and a side CUDA stream
on a card).  The partition budget is shrunk (``--partition-mib``) so the
matrix is ≥16 partitions long, then the centroids are checked against an
in-memory run of the identical streaming schedule (the same reduction
order, so the centroids match to float32 exactness).
"""
import argparse
import tempfile
import time

import numpy as np


def build_dataset(n: int, p: int, k: int, seed: int = 42):
    """Mixture-of-Gaussians generator: returns (means, row-chunk iterator)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(k, p)) * 8
    labels = rng.integers(0, k, size=n)

    def chunks(chunk_rows: int = 1 << 16):
        for ofs in range(0, n, chunk_rows):
            lab = labels[ofs:ofs + chunk_rows]
            yield (means[lab]
                   + rng.normal(size=(lab.shape[0], p))).astype(np.float32)

    return means, chunks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--disk", action="store_true",
                    help="use the on-disk tier (MmapStore) instead of host RAM")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--p", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--partition-mib", type=int, default=4,
                    help="I/O partition budget in --disk mode (MiB)")
    ap.add_argument("--data-dir", default=None,
                    help="registry data dir for --disk (default: a temp dir)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the in-memory equivalence check in --disk mode")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.algorithms import kmeans
    from repro_torch.core import fm

    fm.set_conf(device=args.device)
    n, p, k = args.n, args.p, args.k
    nbytes = n * p * 4
    means, chunks = build_dataset(n, p, k)

    tmpdir = None  # removed at exit when no --data-dir was given
    if args.disk:
        from repro_torch import storage
        budget = args.partition_mib << 20
        data_dir = args.data_dir
        if data_dir is None:
            tmpdir = tempfile.TemporaryDirectory(prefix="fm-kmeans-")
            data_dir = tmpdir.name
        fm.set_conf(data_dir=data_dir, io_partition_bytes=budget)
        print(f"writing MixGaussian ({n}x{p}, {nbytes / 2**20:.0f} MiB = "
              f"{nbytes / budget:.0f}x the partition budget) to disk...")
        store = storage.create_matrix(storage.registry.matrix_path("mixgauss"),
                                      (n, p), np.float32)
        ofs = 0
        for chunk in chunks():
            store.write_rows(ofs, chunk)
            ofs += chunk.shape[0]
        store.flush()
        store.close()
        X = fm.get_dense_matrix("mixgauss")
        assert X.m.on_disk and isinstance(X.m.store, storage.MmapStore)
    else:
        print(f"sampling MixGaussian ({n}x{p}, {nbytes / 2**20:.0f} MiB) "
              "on the host-RAM tier...")
        X_host = np.empty((n, p), np.float32)
        ofs = 0
        for chunk in chunks():
            X_host[ofs:ofs + chunk.shape[0]] = chunk
            ofs += chunk.shape[0]
        X = fm.conv_R2FM(X_host, host=True)

    t0 = time.perf_counter()
    res = kmeans(X, k=k, max_iter=args.iters, seed=0)
    dt = time.perf_counter() - t0

    d = np.linalg.norm(res.centers[:, None] - means[None], axis=-1)
    print(f"done in {dt:.1f}s ({res.iters} iterations, "
          f"{nbytes * res.iters / dt / 2**30:.2f} GiB/s streamed)")
    print(f"wss = {res.wss:.3e}")
    print(f"recovered centers within {d.min(1).max():.3f} of truth "
          f"({(d.min(1) < 0.5).sum()}/{k} exact)")

    if args.disk and not args.no_check:
        # The disk run must reproduce the in-memory run: mode='stream' walks
        # the same partition schedule over the device tier, so the
        # reduction order — and the centroids — agree to float32 exactness.
        print("verifying against the in-memory run...")
        X_mem = fm.conv_R2FM(np.asarray(X.m.logical_data()))
        res_mem = kmeans(X_mem, k=k, max_iter=args.iters, seed=0,
                         mode="stream")
        np.testing.assert_allclose(res.centers, res_mem.centers, atol=1e-5)
        print(f"in-memory centroids match (max diff "
              f"{np.abs(res.centers - res_mem.centers).max():.2e})")
    # Mixture recovery is a property of the data and the seed, not of the
    # tier: checked last, so it cannot mask the disk == memory check.
    assert (d.min(1) < 1.0).all(), "failed to recover mixture centers"
    print("OK")
    return res


if __name__ == "__main__":
    main()
