"""End-to-end driver on the PyTorch port: image search over a partitioned
graph database, served with batched requests (the paper's target cloud
application), through `repro_torch`.

The "image encoder" is a stub (fixed random projection of synthetic image
patches -> 128-dim descriptors), standing in for the SIFT/CNN feature
extraction the paper assumes happens upstream. Everything downstream —
partitioned build, device-resident serving, stage-2 merge, latency/QPS
accounting — is the real system. The index lives on the card unless
`--device cpu` is given; `--serve-async` sends the queries one by one
through the dynamic batcher and the replica pool instead of fixed batches.

  PYTHONPATH=src python examples/torch_image_search_serving.py
  PYTHONPATH=src python examples/torch_image_search_serving.py \\
      --serve-async --replicas 2 --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.api import IndexSpec, SearchService
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.launch.serve import serve_async, serve_loop


def stub_image_encoder(images: np.ndarray, dim: int = 128) -> np.ndarray:
    """images [N, 16, 16] -> L2-normalized descriptors [N, dim]."""
    rng = np.random.default_rng(42)
    proj = rng.normal(size=(16 * 16, dim)).astype(np.float32) / 16.0
    feats = np.maximum(images.reshape(len(images), -1) @ proj, 0.0)
    return 100.0 * feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=6000,
                    help="images in the library")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--serve-async", action="store_true",
                    help="serve through repro_torch.serve (dynamic batcher "
                         "+ replica pool) instead of the sync loop")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the index lives (default: cuda; raises "
                         "when no CUDA device is visible)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    # synthetic "image library": images from 24 texture classes
    classes = rng.normal(size=(24, 16, 16)).astype(np.float32)
    labels = rng.integers(0, 24, args.n)
    library = classes[labels] + 0.3 * rng.normal(
        size=(args.n, 16, 16)).astype(np.float32)
    db_vectors = stub_image_encoder(library)

    print(f"building 4-partition graph database on "
          f"{args.device or 'cuda'} ...")
    t0 = time.time()
    # descriptors are L2-normalized upstream, so cosine is the natural
    # metric — the registry re-normalizes and the search minimizes 1 - cos.
    engine = SearchService.build(
        db_vectors,
        IndexSpec(metric="cosine", backend="partitioned", num_partitions=4,
                  hnsw=HNSWConfig(M=16, ef_construction=100)),
        device=args.device)
    print(f"  built in {time.time()-t0:.1f}s")

    # query stream: noisy views of library images
    q_idx = rng.integers(0, args.n, args.queries)
    q_images = library[q_idx] + 0.3 * rng.normal(
        size=(args.queries, 16, 16)).astype(np.float32)
    queries = stub_image_encoder(q_images)

    if args.serve_async:
        ids, stats = serve_async(engine, queries, k=10, ef=40,
                                 replicas=args.replicas, max_batch=32)
    else:
        ids, stats = serve_loop(engine, queries, batch=32, k=10, ef=40)

    # task metric: does the top-10 contain same-class images?
    hit = np.mean([
        np.mean(labels[ids[i][ids[i] >= 0]] == labels[q_idx[i]])
        for i in range(len(q_idx))])
    print(f"same-class hit-rate in top-10: {hit:.3f}")
    assert hit > 0.5
    print("OK")
    return hit


if __name__ == "__main__":
    main()
