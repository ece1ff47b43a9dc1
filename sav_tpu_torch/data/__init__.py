"""sav_tpu_torch.data"""
