"""Model code of the port: dense decoder LMs (``transformer``) behind the
family-dispatched ``api``."""
