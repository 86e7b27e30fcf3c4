"""What the port needs of the reference's ``distributed`` package: the
parameter specs and their initializer (``sharding``), gradient
compression with error feedback (``compression``), the fault-tolerance
runtime (``fault``), GPipe pipelining (``pipeline``) and DiLoCo
cross-pod training (``diloco``), the last two with their stages or pods
stacked on one device."""
