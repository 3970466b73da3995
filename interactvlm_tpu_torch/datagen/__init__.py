"""Offline datagen: ``generate.py`` (lift maps, contact masks, object
splats), ``recipes.py`` (one tree a dataset) and the CLI
``python -m interactvlm_tpu_torch.datagen {damon,lemon-hu,rich,piad,pico}``
(``__main__.py``)."""
