"""The LM stack of the port (dense decoder-only families): config, layers,
attention (with K5 above ``FLASH_THRESH``), blocks, model assembly."""
