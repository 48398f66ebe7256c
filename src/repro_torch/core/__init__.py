"""Core of the port: the paper's contribution (SRR), the QER baselines,
the activation-aware scalings and QPEFT — the public names of
``repro.core``, with the port's signatures (a ``torch.Generator`` where
JAX takes a key, ``scaling=`` as a keyword; see the README)."""
from repro_torch.core.api import (CalibStats, LayerReport, PTQConfig,
                                  quantize_layer, quantize_tree,
                                  report_summary)
from repro_torch.core.qer import (Decomposition, qer_decompose, scaled_error,
                                  w_only, weight_error)
from repro_torch.core.qpeft import (AdapterParams, AdapterStatic,
                                    adapter_matmul, fixed_gamma_scale,
                                    init_adapter, scale_adapter_grads,
                                    sgp_scale, tree_scale_grads)
from repro_torch.core.rank_alloc import (RankSelection, rho_prefix,
                                         sample_probe, select_rank,
                                         true_reconstruction_error)
from repro_torch.core.scaling import (SCALING_KINDS, Scaling,
                                      identity_scaling, lqer_scaling,
                                      make_scaling, qera_approx_scaling,
                                      qera_exact_scaling)
from repro_torch.core.srr import (SRRResult, preserved_singular_values,
                                  srr_decompose)
from repro_torch.core.svd import (TruncatedSVD, exact_svd, randomized_svd,
                                  singular_values, topk_singular_values)
