"""How each family of configurations drives the port: one module a
family, named by the configuration file's ``family``."""
