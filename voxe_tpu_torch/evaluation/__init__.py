"""Quality metrics over rendered image folders: CLIP similarities, FID, PSNR (counterpart of evaluation/)."""
