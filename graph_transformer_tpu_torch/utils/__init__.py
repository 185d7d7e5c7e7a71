from graph_transformer_tpu_torch.utils.metrics import (
    ari,
    clustering_accuracy,
    clustering_error_majority,
    eval_from_embeddings,
    nmi,
    purity,
    spectral_eval_from_laplacian,
)

__all__ = [
    "purity",
    "clustering_accuracy",
    "clustering_error_majority",
    "nmi",
    "ari",
    "spectral_eval_from_laplacian",
    "eval_from_embeddings",
]
