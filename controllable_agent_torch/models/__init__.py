from .networks import (MLP, Actor, BackwardMap, DiagGaussianActor, ForwardMap,
                       IdentityMap, l2_normalize)

__all__ = ["MLP", "Actor", "BackwardMap", "DiagGaussianActor", "ForwardMap",
           "IdentityMap", "l2_normalize"]
