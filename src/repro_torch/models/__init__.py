from repro_torch.models.model_zoo import ModelBundle, build  # noqa: F401
