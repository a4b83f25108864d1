"""The port's tuning layer for the thesis and serving kernels: the conv
layer description, the schedule space (and the ScheduleBundle of a
serving step), the H100 cost model, the tuning registry, the tuner and
the online selector."""
