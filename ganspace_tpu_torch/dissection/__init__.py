"""GAN dissection in the port (``ganspace_tpu/dissection``): the running
statistics, the stats / conditional / tally / covariance passes, the IQR
and max-IoU scores, the report, the broden reader, the runners, the color,
unified-parsing and ADE segmenters (``segmodel``, ``segmenter``), ACE
(``ace``), the dissection server (``server``) and the ``dissect`` command.
"""

from ganspace_tpu_torch.dissection.ace import ablation_effect, ace_optimize
from ganspace_tpu_torch.dissection.broden import (
    BrodenDataset,
    MultiSegmentDataset,
    ParallelImageFolders,
    write_synthetic_broden,
)
from ganspace_tpu_torch.dissection.dissect import (
    ColorSegmenter,
    SegmenterBase,
    collect_cond_quantiles,
    collect_covariance,
    collect_stats_and_cond_quantiles,
    dissect,
    iqr_max_scores,
    iqr_scores,
    maxiou_scores,
    tally_stats,
    upsample_grid,
)
from ganspace_tpu_torch.dissection.report import generate_report, make_svg_bargraph
from ganspace_tpu_torch.dissection.runners import dissect_classifier, segment_dataset
from ganspace_tpu_torch.dissection.segmenter import (
    SemanticSegmenter,
    UnifiedParsingSegmenter,
    import_torch_upernet,
)
from ganspace_tpu_torch.dissection.segmodel import (
    ResNet,
    ResNetConfig,
    UPerNet,
    UPerNetConfig,
    init_resnet_params,
    init_upernet_params,
)
from ganspace_tpu_torch.dissection.viz import (
    activation_overlay,
    activation_surface,
    plot_max_heatmap,
    plot_tensor_images,
    segment_visualization,
)

__all__ = [
    "dissect",
    "tally_stats",
    "upsample_grid",
    "collect_cond_quantiles",
    "collect_covariance",
    "collect_stats_and_cond_quantiles",
    "iqr_max_scores",
    "iqr_scores",
    "maxiou_scores",
    "SegmenterBase",
    "ColorSegmenter",
    "UnifiedParsingSegmenter",
    "SemanticSegmenter",
    "import_torch_upernet",
    "ResNet",
    "ResNetConfig",
    "UPerNet",
    "UPerNetConfig",
    "init_resnet_params",
    "init_upernet_params",
    "ace_optimize",
    "ablation_effect",
    "BrodenDataset",
    "write_synthetic_broden",
    "MultiSegmentDataset",
    "ParallelImageFolders",
    "dissect_classifier",
    "segment_dataset",
    "generate_report",
    "make_svg_bargraph",
    "activation_overlay",
    "plot_max_heatmap",
    "plot_tensor_images",
    "activation_surface",
    "segment_visualization",
]
