from repro_torch.training.train_loop import make_eval_step, make_train_step

__all__ = ["make_train_step", "make_eval_step"]
