from .train import TrainState, asr_loss, make_train_step

__all__ = ["TrainState", "asr_loss", "make_train_step"]
