"""nn.Modules of the port: blocks, vision trunk, pixel decoder, VTPModel."""
