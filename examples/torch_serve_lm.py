"""Multi-tenant serving on the PyTorch/CUDA port (twin of
examples/serve_lm.py): concurrent analytics over one disk matrix.

    PYTHONPATH=src python examples/torch_serve_lm.py               # a card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Three tenants submit independent requests against the same named
disk-resident matrix from their own threads.  The engine's admission
window coalesces them onto ONE streaming pass — the disk tier is read
once, and each tenant's ``fm.collect_stats()`` scope still reports its
own plan's share.
"""
import argparse
import threading

import numpy as np

from repro_torch.core import fm
from repro_torch.core import materialize as mz

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="the engine's device: 'cuda' (default) or 'cpu'")
args = ap.parse_args()
fm.set_conf(device=args.device)

X_np = np.random.default_rng(0).normal(size=(50_000, 8)).astype(np.float32)
X = fm.load_dense_matrix(X_np, "served_features")  # the disk tier

mz.reset_exec_stats()
with fm.serve(window_ms=200, max_window_requests=3) as engine:
    barrier = threading.Barrier(3)
    results = {}

    def tenant(name, output):
        with fm.collect_stats(name) as scope:
            barrier.wait(timeout=60)
            value = engine.submit(output).result(timeout=120)
        results[name] = (fm.as_np(value), scope.stats())

    threads = [
        threading.Thread(target=tenant, args=("means", fm.colMeans(X))),
        threading.Thread(target=tenant, args=("sds", fm.colSds(X))),
        threading.Thread(target=tenant, args=("gram", fm.crossprod(X))),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)

st = mz.exec_stats()
print(f"3 tenants -> streams={st['streams']} passes={st['passes']}")
if st["streams"] != 1 or len(results) != 3:
    raise SystemExit("the three tenants did not share one scan of the disk "
                     "tier")

for name, (value, stats) in sorted(results.items()):
    print(f"  {name}: shape={np.asarray(value).shape} "
          f"streams={stats['streams']} bytes={stats['bytes_streamed']}")

np.testing.assert_allclose(results["means"][0].ravel(), X_np.mean(0),
                           rtol=1e-3, atol=1e-4)
print("parity with numpy: OK")
