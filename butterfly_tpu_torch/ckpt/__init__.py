from butterfly_tpu_torch.ckpt.load import config_from_hf_dir, load_checkpoint  # noqa: F401
