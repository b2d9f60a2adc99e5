"""The inputs' loaders, frozen from ``zeldaengine_tpu_torch/`` at commit
fcd25b5c3f72ca7067e052cad3b663c2b7f338ae: the world document's reader
(``world.py``, from ``scene/world.py``), the configuration's fields and
defaults (``config.py``, from ``config.py``), the procedural meshes
(``mesh.py``) and the rules that turn a world's objects into meshes and
instances (``prefabs.py``). They read the benchmark's inputs as the engine
reads them; nothing of the frame is here."""
