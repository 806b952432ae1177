"""repro_torch.core — the paper's quantisation-format machinery, in torch.

  distributions  — Normal / Laplace / Student-t + Table-4 statistics
  element        — ∛p, INT, EeMm, NF4/SF4/AF4, quantile, uniform-grid formats
  scaling        — tensor/channel/block × RMS/absmax/signmax, scale formats
  sparse         — sparse-outlier storage
  tensor_format  — TensorFormat / QuantisedTensor / PackedTensor / STE
  nibble         — two 4-bit codes per byte along K
  compress       — entropy accounting + Huffman codec (numpy)
  lloyd          — (Fisher-weighted) Lloyd-Max (numpy)
  search         — quantiser scale and Student-t ν search
  rotations      — random-rotation baseline
  registry       — format-spec strings
  plan           — whole-model quantisation plans and packing
  allocation     — Eq. 5 bit allocation, KV-format allocation (numpy)
  fisher         — diagonal Fisher estimation (autograd) and its summaries
  metrics        — top-k KL, ρ, cross entropy, SNR
"""
from . import (allocation, compress, distributions, element, fisher, lloyd,
               metrics, nibble, plan, registry, rotations, scaling, search,
               sparse, tensor_format)
from .plan import (QuantisationPlan, build_allocated_plan, build_plan,
                   fit_lloyd_plan, verify_packed_tree)
from .registry import HEADLINE_FORMATS, parse_format
from .tensor_format import (IntegrityError, PackedTensor, QuantisedTensor,
                            TensorFormat)

__all__ = [
    "allocation", "compress", "distributions", "element", "fisher", "lloyd",
    "metrics", "nibble", "plan", "registry", "rotations", "scaling", "search",
    "sparse", "tensor_format", "parse_format", "HEADLINE_FORMATS",
    "IntegrityError", "TensorFormat", "QuantisedTensor", "PackedTensor",
    "QuantisationPlan", "build_allocated_plan", "build_plan",
    "fit_lloyd_plan", "verify_packed_tree",
]
