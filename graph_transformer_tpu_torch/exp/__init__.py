from graph_transformer_tpu_torch.exp.hpo import best_arm, optimize

__all__ = ["optimize", "best_arm"]
