from .steady import SolveInfo, SteadyBackwardEuler, SteadyForwardEuler

__all__ = ["SteadyBackwardEuler", "SteadyForwardEuler", "SolveInfo"]
