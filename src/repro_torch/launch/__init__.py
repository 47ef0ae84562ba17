"""Step builders (train, prefill, serve) and the launchers: serving
(``launch.serve``) and training (``launch.train``), the JAX package's
``repro.launch`` on one device.  Its mesh, sharding rules and dry-run
have no port yet (module step 10)."""
