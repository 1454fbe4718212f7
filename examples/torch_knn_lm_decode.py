"""kNN-LM serving on the PyTorch port: LM decode with datastore retrieval
through the ANN engine.

Couples the two halves of the framework: a (reduced) granite-3-8b
backbone decodes tokens while every step queries a partitioned HNSW
datastore of (hidden -> next-token) memories; output distributions
interpolate the LM softmax with the kNN posterior (Khandelwal et al.,
2020 — retrieval itself is the paper's engine).

The LM runs at the REDUCED config's width (d 128, vocab 512, float32) and
the datastore is 24 sequences x 47 positions x 2 rows: a datastore of
this size at granite's full width would take about as long to build as
the main index does (the graph build runs on the host).

`run(device, params=None)` returns the decoded tokens, each step's LM
log-probabilities, mixed log-probabilities and retrieved ids, so tests
and `chip_smoke.py` can hold one device's run against another's, or
against the reference's example on the same weights.

  PYTHONPATH=src python examples/torch_knn_lm_decode.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.configs import reduced_config
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import make_batch
from repro_torch.models.model import decode_step, prefill_step
from repro_torch.models.transformer import forward, init_cache, init_params

ARCH = "granite_3_8b"
LAMBDA = 0.3          # kNN interpolation weight
B, T0, STEPS = 2, 24, 12
K, EF = 8, 32


@torch.no_grad()
def build_datastore(model, cfg, device, n_seqs=24, seq=48):
    """Run the LM over text, record (hidden_t -> token_{t+1}) pairs."""
    keys, values = [], []
    for s in range(n_seqs):
        toks = make_batch(cfg, "train", seq, 2, step=100 + s)["inputs"]
        hid, _, _ = forward(model, cfg, torch.as_tensor(toks).to(device),
                            mode="prefill")
        keys.append(hid[:, :-1].reshape(-1, cfg.d_model).cpu().numpy())
        values.append(toks[:, 1:].reshape(-1))
    return np.concatenate(keys), np.concatenate(values)


def knn_log_posterior(ids, dists, ds_vals, vocab: int) -> np.ndarray:
    """[B, vocab] log-probabilities of the next token from the k retrieved
    memories, each weighted exp(-dist / 10), normalised. The weights are
    taken relative to the nearest memory: the reference's example takes
    exp(-dist / 10) as it is, which underflows to 0 for every memory once
    the distances pass ~900 (float32), and its posterior is then NaN."""
    knn_logp = np.full((len(ids), vocab), -30.0, np.float32)
    for b in range(len(ids)):
        w = np.exp(-(dists[b] - dists[b].min()) / 10.0)
        w = w / w.sum()
        for j, gid in enumerate(ids[b]):
            if gid >= 0:
                v = int(ds_vals[gid])
                knn_logp[b, v] = np.logaddexp(knn_logp[b, v],
                                              np.log(w[j] + 1e-9))
    return knn_logp


@torch.no_grad()
def run(device, params=None) -> dict:
    """Build the datastore and decode STEPS tokens with kNN interpolation
    on `device`, with `params` (the REDUCED granite's parameter module on
    that device; default: `init_params` from seed 0). Returns "tokens"
    [B, STEPS] and, a step each, "lm_logp" and "mixed" [STEPS, B, vocab]
    and "ids" [STEPS, B, K] (numpy), and "memories" (the datastore's
    size)."""
    cfg = reduced_config(ARCH)
    model = init_params(cfg, device=device) if params is None else params
    dev = model["embed"].device
    V = cfg.vocab_size

    ds_keys, ds_vals = build_datastore(model, cfg, dev)
    engine = SearchService.build(
        ds_keys.astype(np.float32),
        IndexSpec(backend="partitioned", num_partitions=2,
                  hnsw=HNSWConfig(M=12, ef_construction=60)),
        device=dev)

    toks = make_batch(cfg, "train", T0, B, step=999)["inputs"]
    cache = init_cache(cfg, B, T0 + 16, device=dev)
    logits, cache = prefill_step(
        model, {"inputs": torch.as_tensor(toks).to(dev)}, cache, cfg)

    out = {"tokens": [], "lm_logp": [], "mixed": [], "ids": [],
           "memories": len(ds_keys)}
    embed = model["embed"][:V]
    for t in range(T0, T0 + STEPS):
        lm_logp = torch.log_softmax(logits[:, 0, :V], -1)
        # the query: the LM distribution embedded through the (tied)
        # embedding table, a cheap stand-in for the pre-head hidden state
        hid_key = (lm_logp @ embed).cpu().numpy()
        resp = engine.search(SearchRequest(
            queries=hid_key.astype(np.float32), k=K, ef=EF))
        ids, dists = resp.ids.cpu().numpy(), resp.dists.cpu().numpy()
        lm = lm_logp.cpu().numpy()
        mixed = np.logaddexp(
            np.log1p(-LAMBDA) + lm,
            np.log(LAMBDA) + knn_log_posterior(ids, dists, ds_vals, V))
        nxt = mixed.argmax(-1).astype(np.int32)
        for key, val in (("tokens", nxt), ("lm_logp", lm),
                         ("mixed", mixed), ("ids", ids)):
            out[key].append(val)
        logits, cache = decode_step(
            model, torch.as_tensor(nxt[:, None]).to(dev), cache, t, cfg)
    out["tokens"] = np.stack(out["tokens"], 1)
    for key in ("lm_logp", "mixed", "ids"):
        out[key] = np.stack(out[key])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args(argv).device
    print("building datastore and decoding ...")
    out = run(device)
    print(f"  {out['memories']} memories of dim "
          f"{reduced_config(ARCH).d_model}")
    print("decoded (kNN-interpolated):", out["tokens"].tolist())
    print("OK")


if __name__ == "__main__":
    main()
