"""The multi-card layer: the (data, model) rank grid and its sharding rules
(``mesh``), the collectives and tensor parallelism's autograd functions
(``collectives``), and a launcher of n ranks from one process
(``launch``)."""
