"""Online model-diffing serving path, ported from :mod:`crosscoder_tpu.serve`:
token streams in, per-request top-k latent activations and decoder-norm
model-diff scores out, with continuous batching over the paged capture
forward, and the replicas' drain hand-off (:mod:`.replica`)."""

from crosscoder_tpu_torch.serve.engine import (InferenceEngine, ServeResult, Shed,
                                               batch_buckets, bucket_of)
from crosscoder_tpu_torch.serve.replica import ReplicaBoard, ServeReplica
from crosscoder_tpu_torch.serve.step import diff_pair, encode_topk_diff

__all__ = [
    "InferenceEngine",
    "ServeResult",
    "Shed",
    "batch_buckets",
    "bucket_of",
    "ReplicaBoard",
    "ServeReplica",
    "diff_pair",
    "encode_topk_diff",
]
