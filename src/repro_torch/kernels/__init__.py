"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the CPU path and the kernel's oracle) and a launch counter.

========================  ============================  =============================
wrapper                   CUDA source                   replaces (TPU kernel)
========================  ============================  =============================
``median_cut_scores``     ``csrc/median_cut.cu``        ``median_cut_scores_batched``
``median_extremes``       ``csrc/median_extremes.cu``   ``median_extremes_batched``
``maxmarg_turn_scan``     ``csrc/maxmarg_turn.cu``      ``maxmarg_turn_scan_batched``
``pegasos_stage``         ``csrc/pegasos_stage.cu``     ``pegasos_stage_batched``
``threshold_ranges``      ``csrc/threshold_ranges.cu``  ``threshold_ranges_batched``
                                                        (and ``threshold_ranges``)
``uncertain_mask``        ``csrc/uncertain_mask.cu``    ``uncertain_mask_batched``
                                                        (and ``uncertain_mask``)
``attention``             ``csrc/flash_attention.cu``   ``flash_attention``
                          (route ``simt``),
                          ``flash_attention_tc.cu``
                          (``tc``),
                          ``flash_attention_splitkv.cu``
                          (``splitkv``)
``rwkv6``                 ``csrc/rwkv6.cu``             ``rwkv6_chunked``
``mamba_scan``            ``csrc/mamba_scan.cu``        ``mamba_scan``
========================  ============================  =============================

``median_extremes_segments`` is the extremes kernel over two segments (own
rows and transcript, read where they lie), counted as ``median_extremes``
launches.  The single-instance TPU kernels are B=1 calls of the batched wrappers
(``threshold_ranges_one``, ``uncertain_mask_one``) and count as their
launches.

Sources build with ``nvcc`` at first launch (:mod:`._build`); importing this
package builds nothing.

Gradients: ``rwkv6_autograd`` and ``mamba_scan_autograd`` launch the
kernel forward (one launch, counted as the wrapper's) and differentiate
the plain version backward in 64-token chunks (:mod:`._grad`, no launch).
A raw launch of ``rwkv6``, ``mamba_scan`` or ``attention`` on inputs that
require a gradient raises: its outputs would carry none.
"""

from typing import Dict

from repro_torch.kernels.flash_attention import (  # noqa: F401
    attention,
    attention_plain,
)
from repro_torch.kernels.mamba import (  # noqa: F401
    mamba_scan,
    mamba_scan_autograd,
    mamba_scan_plain,
)
from repro_torch.kernels.median_cut import (  # noqa: F401
    median_cut_scores,
    median_cut_scores_plain,
)
from repro_torch.kernels.pegasos import (  # noqa: F401
    pegasos_stage,
    pegasos_stage_plain,
)
from repro_torch.kernels.support_margin import (  # noqa: F401
    maxmarg_turn_scan,
    maxmarg_turn_scan_plain,
    Extremes,
    median_extremes,
    median_extremes_plain,
    median_extremes_segments,
    median_extremes_segments_plain,
    threshold_ranges,
    threshold_ranges_one,
    threshold_ranges_plain,
    uncertain_mask,
    uncertain_mask_one,
    uncertain_mask_plain,
)
from repro_torch.kernels.rwkv6 import (  # noqa: F401
    rwkv6,
    rwkv6_autograd,
    rwkv6_plain,
)

WRAPPERS = (median_cut_scores, median_extremes, maxmarg_turn_scan,
            pegasos_stage, threshold_ranges, uncertain_mask, attention,
            rwkv6, mamba_scan)


def reset_launches() -> None:
    """Set every wrapper's launch count, and the attention routes' counts,
    to 0."""
    for w in WRAPPERS:
        w.launches = 0
    attention.routes = dict.fromkeys(attention.routes, 0)


def launches() -> Dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launches`."""
    return {w.__name__: w.launches for w in WRAPPERS}
