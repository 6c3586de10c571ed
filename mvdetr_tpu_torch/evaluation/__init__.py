from mvdetr_tpu_torch.evaluation.clear import clear_metrics, evaluate_files

__all__ = ["clear_metrics", "evaluate_files"]
