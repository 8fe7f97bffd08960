"""Loss functions of the ported stages (stage 4: ``revise``)."""
