from tpurt_torch.utils.progress import ProgressReporter, mrays_per_second  # noqa: F401
