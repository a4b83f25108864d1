"""The port's tuning layer for the thesis kernels: the conv layer
description, the schedule space, the H100 cost model, the tuning
registry, the tuner and the online selector."""
