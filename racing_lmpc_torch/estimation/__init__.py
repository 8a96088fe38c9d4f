"""State estimation of the port: the extended Kalman filter."""

from racing_lmpc_torch.estimation.ekf import (
    EKFAlreadyInitializedException,
    EKFStateEstimator,
    EKFUninitializedException,
    NoObservationRegisteredException,
    ObservationNameAlreadyExistsException,
    ObservationNameNotFoundException,
)

__all__ = [
    "EKFStateEstimator",
    "EKFAlreadyInitializedException",
    "EKFUninitializedException",
    "NoObservationRegisteredException",
    "ObservationNameAlreadyExistsException",
    "ObservationNameNotFoundException",
]
