"""repro_torch.core — the paper's quantisation-format machinery, in torch.

  distributions  — Normal / Laplace / Student-t + Table-4 statistics
  element        — ∛p, INT, EeMm, NF4/SF4/AF4, quantile formats
  scaling        — tensor/channel/block × RMS/absmax/signmax, scale formats
  sparse         — sparse-outlier storage
  tensor_format  — TensorFormat / QuantisedTensor / PackedTensor
  nibble         — two 4-bit codes per byte along K
  registry       — format-spec strings
  plan           — whole-model quantisation plans and packing
  allocation     — Eq. 5 bit allocation, KV-format allocation (numpy)
  fisher         — diagonal Fisher estimation (autograd) and its summaries
  metrics        — top-k KL, ρ, cross entropy, SNR
"""
from . import (allocation, distributions, element, fisher, metrics, nibble,
               plan, registry, scaling, sparse, tensor_format)
from .plan import (QuantisationPlan, build_allocated_plan, build_plan,
                   verify_packed_tree)
from .registry import parse_format
from .tensor_format import (IntegrityError, PackedTensor, QuantisedTensor,
                            TensorFormat)

__all__ = [
    "allocation", "distributions", "element", "fisher", "metrics", "nibble",
    "plan", "registry", "scaling", "sparse", "tensor_format", "parse_format",
    "IntegrityError", "TensorFormat", "QuantisedTensor", "PackedTensor",
    "QuantisationPlan", "build_allocated_plan", "build_plan",
    "verify_packed_tree",
]
