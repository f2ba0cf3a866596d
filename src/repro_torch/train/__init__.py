from .train_step import TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "init_train_state", "make_train_step"]
