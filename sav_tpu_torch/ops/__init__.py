"""sav_tpu_torch.ops"""
