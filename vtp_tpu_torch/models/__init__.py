"""nn.Modules of the port: blocks, vision trunk, pixel decoder, text tower, DINO head, VTPModel."""
