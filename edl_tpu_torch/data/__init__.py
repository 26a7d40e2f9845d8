"""Input side of the port: the synthetic and image-folder pipelines
(``input_pipeline``) and the host-to-device prefetcher (``prefetch``)."""
