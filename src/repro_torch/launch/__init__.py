"""Entry points of the port: serving (``serve``, ``serve_engine``), the
trainer (``train``), the meshes (``mesh``) and the production-mesh dry run
(``specs``, ``dryrun``)."""
