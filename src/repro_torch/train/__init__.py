from repro_torch.train.loop import TrainLoop, make_train_step
