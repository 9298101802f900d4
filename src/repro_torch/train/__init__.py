from .steps import TrainState, init_train_state, make_train_step
