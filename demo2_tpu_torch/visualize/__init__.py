from .saliency import attention_rollout, gradcam, gradcam_heatmaps, save_gradcam_overlays
from .embedding import tsne_plot
from .rank_list import save_rank_list, visualize_ranked_results
from .similarity import similarity_distributions
