"""nn.Modules of the port: blocks, vision trunk, pixel decoder, text tower, DINO head, VTPModel,
and the auxiliary layers of ``extras`` (causal block, custom attention, pooler, multimodal tower)."""
