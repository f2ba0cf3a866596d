"""Launch layer: the production training launcher (``train``), the
meshes and their hardware constants (``mesh``), the multi-pod dry run
(``dryrun``) and its roofline terms (``roofline``)."""
