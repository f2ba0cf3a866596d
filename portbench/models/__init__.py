"""One module a model family: ``port_config(cfg)`` builds the port's
``ModelConfig`` from a configuration file, ``layout(cfg)`` lists the
benchmark's weights in groups (group 0: embedding, final norm and head;
group ``i + 1``: layer ``i``), each leaf with the port's name for it."""
