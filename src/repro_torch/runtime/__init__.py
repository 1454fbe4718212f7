from repro_torch.runtime.trainloop import TrainLoop, TrainLoopConfig

__all__ = ["TrainLoop", "TrainLoopConfig"]
