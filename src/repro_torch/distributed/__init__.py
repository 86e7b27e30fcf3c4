"""What the port needs of the reference's ``distributed`` package: the
parameter specs and their initializer (``sharding``)."""
