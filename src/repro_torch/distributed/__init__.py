"""What the port needs of the reference's ``distributed`` package: the
parameter specs and their initializer (``sharding``), gradient
compression with error feedback (``compression``) and the fault-tolerance
runtime (``fault``)."""
