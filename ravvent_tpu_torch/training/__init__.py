from ravvent_tpu_torch.training.loop import Trainer, make_optimizer  # noqa: F401
