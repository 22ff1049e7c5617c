from .train import TrainState, TrainStep, asr_loss, make_train_step

__all__ = ["TrainState", "TrainStep", "asr_loss", "make_train_step"]
