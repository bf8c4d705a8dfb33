"""The device half of the matcher (PyTorch): the candidate search
(``candidates`` for the grid backend, ``dense_candidates`` for the CUDA
sweep), the Viterbi decode (``hmm``) and the per-batch program
(``match``). The names the JAX package's ``reporter_tpu.ops`` exports."""

from reporter_tpu_torch.ops.candidates import find_candidates
from reporter_tpu_torch.ops.dense_candidates import (CandidateSet,
                                                     find_candidates_dense)
from reporter_tpu_torch.ops.hmm import viterbi_decode
from reporter_tpu_torch.ops.match import match_batch, match_trace, match_traces

__all__ = [
    "CandidateSet",
    "find_candidates",
    "find_candidates_dense",
    "viterbi_decode",
    "match_batch",
    "match_trace",
    "match_traces",
]
