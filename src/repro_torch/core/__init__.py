from repro_torch.core.engine import DiffusionEngine, make_engine  # noqa: F401
